"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the repository root on a machine with the card:

    python3 chip_smoke.py

It drives the port (`imaginary_tpu_torch`) and never JAX or `imaginary_tpu`.
Phases, in order; any failure raises and exits non-zero:

1. environment: card name and power limit, torch and CUDA versions;
2. build: the twelve CUDA sources of the thirteen kernels (nvcc, sm_90a,
   in parallel), the native host codec (JPEG, PNG, WEBP, GIF and TIFF;
   the build line names each library's link route and `FORMATS`) and the
   native entropy codec of the DCT transport (g++), with the time each
   took; then (2b) the host codec on CODEC_SEED's inputs against
   CODEC_DIGESTS, pinned from the JAX package on the CPU by
   tests/test_torch_native_codecs.py: the GIF bytes (the in-tree codec),
   the decoded pixels of a PNG, a palette PNG, 16-bit PNGs with and
   without gAMA and TIFFs (lossless), and for lossy WEBP its dims and
   status; then (2c) hostile bytes through that build in a child process
   (`robustness_sweep`): a seeded 64x96 frame encoded as JPEG, PNG, WEBP,
   GIF and TIFF, every cut of its first 64 bytes and ~180 strided cuts
   of the rest, and 1500 seeded mutations of 1-3 flipped bits, each
   through `decode` and `probe` (the JPEG's also through `probe_fast` and
   `decode_yuv420`), the counts of results, ImageErrors and anything else
   printed a format; anything else, a crash or a hang of the child fails
   the phase;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' shapes (config 1: B=1 and B=16; config 2's orientation
   kernel: the /rotate chain's 1080p buckets at B=1 and B=32 in each
   single mode and as the runs it launches once (rotate=90, 180 and 270,
   EXIF 7), each run also bit-equal to its stages launched one by one and
   timed beside them, uint8 in and out, and its W-shard forms over four
   shards of the 4K frame beside the whole kernel; K1, K2 and K3 at config 2's B=32 shapes; config 3's K1 on the
   4K PNG's uint8 [1, 2560, 4096, 3] bucket, and in its W-shard form over
   four shards (each shard's input window alone, bit-equal to the whole
   launch's columns; also to width 800, whose 200-column shards end
   inside a 32-column tile), the blur (K6) at
   [B, 736, 1280, 3] for B=1 and 8 and at r=64, sigma=0 and uint8 input,
   the composite (K7) in both modes at C=3 and 4, the gray (K8) at C=3 and
   4) and at full 1080p; K1 and K4 at the seams of their designs (K1 at
   dims off its tile, mixed scales in one batch, 1080p to 8x8, a 4x
   upscale, uint8 in and out, C = 1 and 4; K4's window at odd and
   negative offsets in every dtype pair, clamp, mirror and fill with
   per-image offsets at B=32; K6 with valid dims one pixel inside and past
   its strips and row runs, at C = 1 to 4, uint8 in and out, an image
   smaller than r = 64 and sigma 0 beside sigma > 0; K2 at odd dims, 1x1, a
   full bucket and buckets with wb % 4 == 2; K3 at the seams of its row
   pairs and 128-column chunks (PACK_SEAM_CASES: odd dims, valid edges on
   and past a chunk, 1x1 and empty images, wb % 4 == 2, an unaligned
   input), plain and with its luma; K8 in each dtype pair at C = 3 and 4,
   with scalar tails and on unaligned W-shard views (GRAY_CASES); K3's
   fused luma form at the bw /resize's [1, 368, 640, 3] against K8's and
   K3's plain versions one after the other, bit-equal to the two kernels
   launched in turn and timed beside them; K11 and K12 at the seams of
   their tiles (DCT_SEAM_CASES: odd valid dims inside larger buckets, B=3
   batches of different dims, buckets 8 rows short of a tile and one tile
   wide, every layout at k = 8, the three-plane layouts at k = 1, 2, 4, K12
   at the /resize?width=1600 bucket; K11's and K12's W-shard entries at
   DCT_SHARD_SEAM_CASES, each shard bit-equal to the whole kernel's
   columns and within tolerance of its plain version: every layout at k =
   8 and the three-plane layouts at k = 1, 2, 4 on shards of a partial
   tile, odd valid dims, the valid chroma edge in a halo block, shards
   wholly past the valid width whose clamp block lies outside their
   natural window, a B=3 batch, K12's MCUs straddling two shards, shards
   past the valid width, odd h; K9 and K10 at the seams of theirs,
   SAL_SEAM_CASES: buckets from 8x8 to 64x8192 and a 2160x3840 frame,
   heights that leave row chunks empty, widths under and just over 256,
   short, one-row, one-column and mixed valid dims, windows equal to the
   valid dims, larger and 1x1, uint8 and f32, C = 3 and 4, and a flat
   image whose windows all tie; then a line with each redesigned kernel's
   largest error); config 4's saliency (K9) and window argmax (K10)
   at f32 [8, 320, 640, 3] and [1, 320, 640, 3] with mixed valid dims,
   with torch.profiler counting the device kernels of one call of each
   (K9 two, its row and column passes; K10 one cluster launch); the
   IDCT (K11) on large.jpg's packed coefficients at 1080p 4:2:0 (k = 8)
   and at the main path's shrink 4 (k = 2), and once each on 4:2:2,
   4:4:4 and gray; the forward DCT (K12) at the two /resize outputs of
   phase 9 (208x304, 928x1600) and a 1088x1920 output; the chain-ending
   wrappers' `out=` (buffer donation): an out of the wrong shape, dtype or
   layout refused, K3 at config 1's B=16 and K7 at config 3's B=8 written
   into a donor region (offset 0 of the staged input's size) equal to
   their plain versions and to themselves undonated; each with the stated tolerance (f32 outputs
   1e-3 absolute on the 0-255 scale, uint8 outputs 1 LSB, the
   orientation kernel exact, K9's integral image 1e-5 relative, K10's
   offsets exact on K9's own integral image, K12's int16 within 1 with
   at most 0.1 % of them differing), its median time from CUDA events,
   the plain version's
   time, the least time the card could take (bytes over 3.35 TB/s or FLOPs
   over 67 TFLOP/s f32, whichever is larger) and, where one PyTorch call
   computes the same function, that call's time;
4. config 1's path: the port's HTTP server (the aiohttp app of
   `create_app`, run by `make_server`; phases 6-10 serve through it too)
   in-process on 127.0.0.1 serving POST /resize and
   /crop?width=300&height=200 on
   tests/testdata/large.jpg three times each on `cuda`, with every
   kernel's launch counter set to 0 just before and read just after (one
   launch each of K2, K1, K4 and K3 a request, and nothing else); the
   server's packed output planes for the same plan on cuda and on cpu
   agree to 1 LSB (also for config 2's /thumbnail and /rotate plans and
   the colorspace=bw /resize, whose K8 folds into K3 on the yuv420
   transport);
5. batch: `run_batch` cuda against cpu, to 1 LSB, at B=16 on config 1's
   plan, at B=32 on config 2's /thumbnail, /crop, /rotate?rotate=90 and
   EXIF-6 /resize plans, and at B=1 and B=8 on config 3's /pipeline chain
   (4K PNG) and the 1080p JPEG /pipeline chain, each image with its own
   noise;
6. config 2's path under load: the server with --max-batch 32
   --batch-form-ms 5 serving 32 client threads, 8 requests each, cycling
   through /thumbnail, /crop and /rotate?rotate=90 on large.jpg and
   /resize of the EXIF-rotated tests/testdata/exif-orient-6.jpg at equal
   weights (the smoke's own mix, chosen, not measured traffic), in two
   timed windows with the launch counters set to 0 just before and read
   just after: each route served alone first, its launches equal to its
   plan's (one K5 launch a /rotate and one an EXIF-6 /resize: the
   orientation fold), every answer 200 image/jpeg of the expected size,
   batches formed (largest group at least 2), every request's decoded planes
   within 1 LSB of the same request served alone; requests per second by
   window, p50/p99 latency, items per batch, and the card's busy share
   over a fourth, profiled window;
7. config 3's path (BASELINE.json config 3): the server serving
   bench_latency.py's exact /pipeline chain [resize 1280, blur 1.2,
   watermark "bench" 0.5, convert webp] on a 3840x2160 PNG made here from
   a seed, bench_latency.py's 1080p JPEG /pipeline [crop 1600x900, resize
   640, blur 1.5, convert jpeg] on large.jpg and a colorspace=bw /resize,
   one request at a time with the launch counters set to 0 just before
   and read just after (each kernel launched exactly as often as the
   plans say, identity ShrinkBucketSpecs dropped by the chain, so config
   3 launches no K4, and the bw /resize's K8 folded into its K3: 0 gray
   and 1 yuv420_pack a request, re-derived from the specs here); the
   card's busy time and kernels of a bw /resize request over a profiled
   window; every answer 200 with the right MIME type and size; the
   WEBP within a PSNR bound of the same chain's array on the CPU; p50/p99
   of one client, then requests per second, p50/p99 and the busy share
   from 8 client threads in two windows; and the host steps of one
   request on the host clock (median of 5): the PNG decode and WEBP
   encode through the port's native module, and Pillow's on the same
   bytes beside them for the record;
8. config 4's path (BASELINE.json config 4): the server (--max-batch 16
   --batch-form-ms 5) serving /smartcrop?width=300&height=300 on
   bench_firehose.py's stream (24 images from seed 11, 420-780 x
   560-1100, JPEG / PNG / WEBP, a salient disc each), made here with
   numpy and Pillow: one request at a time with the launch counters set
   to 0 just before and read just after (equal to the plans'), then 16
   clients in two timed windows and a profiled third (req/s, p50/p99,
   mean batch, busy share), every answer under load byte-equal to the
   same request alone; and for every image the card's window offsets
   against the plain version's on the CPU (equal, or the card's window
   holds the CPU window's saliency within 1e-5 relative, counted);
9. the DCT transport: a server with --transport-dct
   --transport-dct-egress serving /resize?width=300&height=200 (shrink
   4, k = 2) and /resize?width=1600 (shrink 1, k = 8) on large.jpg, with
   the launches held equal to the plans' (one K11 and one K12 a
   request), the native entropy arm and no
   request refused by the codec's scope gate; each served JPEG's
   quantized coefficients within 1 (at most 0.1 % differing) of the same
   request on the CPU, its pixels within 1 LSB wherever an MCU's
   coefficients agree; and the host steps (entropy decode, chain,
   entropy encode) on the host clock; then the restart-segment fan-out:
   phase 10(d)'s 8000x6000 4:2:0 frame and large.jpg saved with a
   restart marker after every MCU row, /resize?width=3000 (k = 4, K11 ->
   K1 -> K3) and /resize?width=300&height=200 on --transport-dct servers
   with --dct-native native, numpy and python (large.jpg only), each with
   its request pool as the segment pool, then with the pool detached:
   every answer of a source the same bytes, the launches the plans', the
   48 MP entropy decode serial and fanned out (median of 5) and the p50;
10. multi-GPU: (a) `parallel/spatial.sharded_blur` on two f32 4K frames
   [2, 2160, 3840, 3] (valid 2100x3800, ending inside the last shard, and
   2160x1920, ending at a seam) at r = 8 (sigma 3) and r = 64 (sigma 20)
   on meshes (1, 4) and (2, 2) over four entries of card 0 (and over the
   real cards when there are several): the counted run (one call per
   mesh at r = 8, launches reset just before and read just after, one K13
   launch per shard, no other kernel), K13 against its plain version at
   every shard, the whole call against K6 bit for bit and against its
   plain version within 1e-3, a uint8 frame, and the times of the shards'
   K13 launches, the exchange, the whole call and K6 on the same image; (b) the server
   started from the command line with `--mesh-policy lanes` (one lane per
   card) under phase 6's mix from 32 clients in two windows, every
   answer byte-equal to the `--mesh-policy off` server's, /health showing
   one lane per card whose dispatches sum to the batches; (c) servers
   with lanes and with sharded dispatch over four entries of card 0 under
   the same mix: every lane dispatches, every answer byte-equal, the
   lanes' ledgers at rest, chunks split over the mesh; then
   `device.chip_error[1]` with a breaker threshold of 1 quarantines lane
   1 while every answer stays byte-equal and the mesh generation rises
   by 1. The off server serves the same mix before and after them in the
   same call. Every server of (b) and (c) runs one host-pool worker per
   client thread (--cpus 32), so each of four lanes forms chunks of the
   sharded threshold. Requests per second and p50/p99 are printed as
   findings;
   (d) the spatial route: config 3's /pipeline and the dry run's chain
   (/resize?width=1920&sigma=2&colorspace=bw, as JPEG) on phase 7's 4K
   PNG, and /resize?width=1920, /blur?sigma=2, /flip, the dry run's
   chain, /crop?width=3000&height=2000, /smartcrop?width=2400&height=2000,
   /rotate?rotate=90, /flop and an embed with a white fill
   (/resize?width=3000&height=2000&extend=white) on the same frame
   encoded by Pillow as a 4:2:0 JPEG (quality 90, subsampling=2), and
   /resize?width=1920 on it with EXIF orientation 6, which run on the
   yuv420 transport. First K2's and K3's
   W-shard forms at the seams of their designs (SHARD_SEAM_CASES: odd
   widths, the valid chroma edge in a shard's halo, shards wholly past
   the valid width, a 6144-wide bucket holding 4100 columns, the edge on
   a seam), each shard bit-equal to the whole image's kernel at its
   columns and within tolerance of its plain version, K3 with and
   without K8's luma. Then each chain launched W-sharded over four
   entries of card 0 (`chain.launch_spatial`), plus large.jpg's /blur,
   whose plan holds a bucket shrink: every shard's K2, K1, K13, K7, K8,
   K4 (shrink, extract, embed, the smartcrop's gather from K10's keys),
   K5 (flip, flop, transpose), K9 (rows, then scan and columns), K10 or
   K3 launch held against its plain version on the same inputs (K2 with
   its chroma halos, K1, K4 and the flop on windows from the window
   exchange, the transpose on row bands from the all-to-all, K13 and K9
   after the halo exchange, K9's scan after every shard's segment totals,
   K10 on an integral-image window, K7 with its shifted `left`, K3 with
   K8's luma folded in), no gather, the output bit-equal to the unsharded
   chain's, the smartcrop's integral-image shards bit-equal to K9 on the
   frame; the new forms' shards each timed beside the unsharded kernel on
   the same input, and the row-band exchange and the smartcrop's image
   window exchange against their read-once-write-once bounds; config 3's K13 shards timed beside
   K6 on the same columns (K13's row in the kernels line), the 4K JPEG's
   four K2 shards beside K2 on the whole packed frame, its four K3 shards
   (4K /blur and 1080p /resize) beside K3 on the same columns, its four
   K5 flip shards beside K5 on the frame, the shrink plan's four K4
   shards beside K4 on the same columns, and the window exchange ahead
   of the /resize's K1 (its bytes and time). Then
   two requests of each chain one at a time, from the off server, from
   a `--mesh-policy lanes` server over four entries of card 0 with
   `--spatial 4` and the default bar, and from the off server again:
   every answer byte-equal to the off server's, /health's
   spatial_batches rising by the requests and spatial_gathers empty, the
   launches of the counted run 4 of each sharded stage's kernel a request
   (K1 + K13 + K7 or K8 on the PNG; K2, K1, K13, K4, K5, K3 on the JPEG,
   12 K9 launches and 4 K10 a smartcrop, and no K8 beside a K3), the p50
   of each chain on each server and the
   card's busy time a request of each chain on each (one profiled window
   a server, split by the requests' windows) as findings; then the same
   on three servers with --transport-dct --transport-dct-egress for the
   dct chains (SPATIAL_DCT_REQUESTS): the 4K frame as a 4:2:0 JPEG at
   /resize?width=1920, /crop, /rotate?rotate=90 and /smartcrop, as
   4:2:2, 4:4:4 and gray JPEGs at /resize?width=1920, scaled to
   8000x6000 at /resize?width=3000 (k = 4), and a progressive 4:2:0
   /resize (egress off: K11 -> K1 -> K3), each shard's K11 and K12 held
   against its plain version in the shard check, K11's shards (the 4K
   and 48 MP frames) and K12's (the 4K /resize) timed beside the whole
   kernel, and 4 K11 and 4 K12 launches a request (4 K3 on the
   progressive one), no gather;
11. the HTTP layer on the card: config 1 (GET
   /img/resize?width=300&height=200&file=large.jpg) through a server
   started from the command line with --key, --path-prefix /img,
   --mount tests/testdata, --enable-placeholder, --return-size,
   --http-cache-ttl 60 and --concurrency 20 --burst 5, requests paced
   under the throttle's rate, with the launch counters set to 0 just
   before and read just after (one launch each of K2, K1, K4 and K3 a
   request, and nothing else): every answer 200 image/jpeg of 300x200
   with the request's X-Request-ID echoed, X-Imaginary-Backend: device,
   Image-Width/Height, the TTL's Cache-Control and a Server-Timing that
   carries the executor's batch_form, dispatch_wait and drain;
   /img/info answers large.jpg's JSON; /img/metrics counts every request
   sent to /img/resize; a failing /img/resize?width=300&height=200 (bytes
   that are no image) answers the original 406 with a 300x200
   placeholder JPEG and its Error header, made by kernel launches on the
   card (counted from 0 as above); a request without the key 401; and a
   burst of BURST_REQUESTS at once past the throttle gets 429s with
   Retry-After;
12. URL sources and watermarkImage on the card: a local aiohttp origin on
   127.0.0.1 (large.jpg, imaginary.jpg, a seeded 240x96 RGBA PNG mark
   with an alpha ramp, phase 7's 4K PNG, phase 8's stream, a 404, a route
   answering 503 with Retry-After: 0 once and 200 after, and a body one
   byte over the cap; it counts GETs and HEADs and keeps the headers it
   saw), and servers from the command line with --enable-url-source,
   --allowed-origins (the origin), --max-allowed-size URL_CAP,
   --enable-auth-forwarding, --forward-headers X-Chip-Smoke and
   --source-retries 2 on cuda, on cpu, and on cuda with --mount: (a)
   config 1 as GET /resize?width=300&height=200&url=.../large.jpg,
   byte-equal to ?file=large.jpg on the mounted server, one launch each
   of K2, K1, K4 and K3 (the wrapper counts, and torch.profiler's kernels
   in a window of one request), its card busy time beside ?file='s in
   turns; (b) /watermarkimage?url=.../large.jpg&image=.../mark.png
   &top=40&left=1500&opacity=0.6 (the planner clamps the mark to the
   right edge; K2 -> K7 -> K4's bucket shrink -> K3) and a /pipeline
   [resize 1280,
   watermarkImage] on ?url= of the 4K PNG (K1 -> K7): one K7 launch each,
   placed (replicate=0, by the plan and by the wrapper's argument), the
   chain's planes on cuda within 1 LSB of its plain versions, the PNG
   answer within 1 LSB of the cpu server's and the JPEG answer by phase
   9's rule (coefficients within 1, pixels within 1 LSB wherever an MCU's
   coefficients agree); (c) the origin's 404 as 502 with status=404,
   ?url=not-a-url 400, an origin off the allow-list 400, the oversize
   body 413, with the reference's JSON messages, the 503-then-200 route
   200 after exactly two GETs, and the origin seeing Authorization from
   X-Forward-Authorization, X-Chip-Smoke and a traceparent; (d) config
   5's stream (phase 8's 24 images) as /resize?width=300&type=jpeg over
   ?url= and as POSTed bodies in turns, one at a time and from 16 clients
   for one window: p50/p99 and req/s beside the card's name and power
   limit.

13. the prewarm, the deadline and the goldens on the card: (a) `python -m
   imaginary_tpu_torch --prewarm --mount tests/testdata` as a fresh
   process: its prewarm line (programs warmed, 0 failed, seconds) and
   boot time, its /health's kernel launches (the prewarm's own: K1-K4
   at least) and compile_misses 0 before any request, then each prewarm
   `_COMMON` route as a GET on large.jpg or imaginary.jpg (740x550) three
   times one at a time and from PREWARM_CLIENTS clients at once (chunks
   of several B), compile_misses still 0; then the same requests to a
   fresh process without --prewarm, which counts compile misses; both
   servers' first-request latency and p50s on the host clock beside the
   card's name and power limit; then a third with --prewarm
   --transport-dct --transport-dct-egress, whose prewarm launches K11
   and K12 and whose routes ride the DCT transport with no miss; (b) a server with --request-timeout 0.15
   (`make_server`): device.execute=delay(200ms) answers 504 at the
   reference's stage, X-Request-Timeout: 0.001 with
   codec.decode=delay(50ms) a 504, a host-pool backlog past the budget a
   503 with Retry-After, and with the failpoints cleared a 200 with the
   executor's device_owed_mb back to 0; (c) every MATRIX, PIPELINES and
   SMARTCROP case of tests/gen_goldens.py through the port's
   process_operation on the card: exact dims, the pipelines' SampleSpec
   counts, PSNR >= 45 dB against tests/goldens/, and K10's smartcrop
   window equal to tests/goldens/smartcrop_window.json; (d) config 3's
   chain (K1 -> K6 -> K7) whole on one staged input, by the kernels and
   by their plain versions, timed, within 1 LSB; then the bounds of the
   kernel_ab.py cases PERF.md lists (LISTED_BOUNDS).

14. the fault domain and the host placement: first every server of
   phases 4-13 (each in-process server's /health block read as it
   closed, each server process's /health before its stop) shows spilled
   0, breaker_host_served 0 and hedges launched 0; then (a) config 1 as
   GET on large.jpg through a server with --integrity --integrity-sample
   1.0 --failslow-ratio 3 --host-spill on (breaker cooldown 2 s; host
   placement on, for the outage's host serving): 20 answers on the card,
   byte-equal to phase 4's, checks equal to chunks and 0 mismatches, the
   golden probe's warm ms and the card's golden output's max and mean
   |d| against the host's golden; then device.corrupt: every answer
   re-served from the host's verified copy (`X-Imaginary-Backend: host`),
   mismatches and corruption strikes counted, the card quarantined and
   breaker_host_served counting; the failpoint cleared, the golden probe
   re-admits the card after its clean probes and the answers (and K2's
   and K3's launches) are back on the card; (b) device.oom on a B=8 chunk
   of phase 6's /thumbnail (oom_events and oom_splits counted, every
   answer 200 on the card and byte-equal to the unsplit burst), then a
   real torch.cuda.OutOfMemoryError: an in-process executor under
   torch.cuda.set_per_process_memory_fraction, the cap set from the
   allocator's measured need of a B=2 chunk of 4K frames so that B=16
   cannot be allocated, the B=16 chunk bisected and served on the card
   bit-equal to the uncapped run, the fraction restored after; (c) with
   drain_watchdog_s 2, a drain that hangs (a fetch that blocks, as the
   reference's tests of its watchdog make it) fails its future with the
   reference's error, device_owed_mb returns to 0 and the next request is
   served on the card; (d) --hedge-threshold-ms 50 with
   device.slow=delay(300ms): the host twin wins (hedges_won, `host`), 20
   calm requests launch 0 hedges, and an X-Request-Timeout of 40 ms
   launches none; (e) four lanes on card 0 with fail-slow armed and
   device.slow[1]=delay(30ms): lane 1 is demoted and leaves the rotation,
   16 requests go to the others, and it is re-admitted once the failpoint
   is cleared; (f) --force-host on config 1: `host`, spilled 1, no kernel
   launched, within the integrity bars (96, 16) of the card's answer.

15. the executor's admission half on the card, every server from the
   port's command line with --prewarm, the launches of the paths each
   case drives summed in the kernels line's `launches_admission`: (a)
   phase 6's mix (32 clients x 8, two windows) on `--batch-policy
   convoy --batch-window-ms 3` and on the default continuous policy (both
   --max-batch 4 --cpus 32): every convoy answer byte-equal to the
   continuous server's answer to the same request alone, groups below
   batches under convoy, compile_misses 0 on the prewarmed `_COMMON`
   routes (the mix's /rotate and EXIF /resize chains are not prewarmed:
   their misses are printed), req/s, p50/p99, avg_batch, avg_group and
   batch_form/dispatch_wait p50/p99 of each; (b) the memory governor
   (--pressure-rss-mb) held by the memory.rss failpoint at its critical
   rung, --pressure-batch-mb from config 1's wire MB so that the rung's
   cap (half of it) is 2.5 items wide: 16 config 1 requests at once, then
   8 of config 3, each launch within the cap (config 3 one item a launch),
   pressure_capped_batches counted, every answer byte-equal to the
   ungoverned server's, no compile miss; a 16.3 MP source 413 with
   Retry-After 2 (the clamp at a quarter of --max-allowed-resolution 60),
   /flip of a 13.2 MP source forced to the host (pressure_host_forced,
   `X-Imaginary-Backend: host`, no kernel); (c) --qos-config with an
   interactive and a batch key splitting phase 6's mix, --max-queue-ms 20,
   --cpus 32 --max-inflight 1: per-class p50/p99, dispatched, shed and
   share-cap 503s, device_owed_mb and host_inflight 0 at rest, and at the
   critical rung the batch tenant's 503 with Retry-After 2; (d) config 1
   and config 3 through servers with --donation on and off, bit-equal,
   and each chunk (config 1 B=16, config 3 B=8) launched both ways:
   torch.cuda.max_memory_allocated above the start and K3's and K7's
   times writing fresh and donated; (e) five config 1 requests at B=1:
   wire_bytes h2d and d2h equal five times the staged and fetched bytes
   the plan gives, and with --arena-mb 64 the codec arena's reuses; (f) a
   ServerProcess SIGTERMed under 8 keep-alive clients: in-flight 200s,
   then 503s with Retry-After, /health 200 until the process exits 0.

16. the cache tiers on the card, every server from the port's command line
   with --prewarm (--max-batch 4), the launches of the paths each case
   drives summed in the kernels line's `launches_cache`: (a) eight config 1
   GETs with --cache-result-mb 64: one miss, seven hits that launch no
   kernel, every answer byte-equal to an uncached server's with one
   ETag, If-None-Match 304 with the ETag (and Vary on a type=auto GET),
   the hit p50 beside the miss on the host clock; (b) --cache-coalesce
   --request-timeout 30: 32 identical config 1 GETs at once (the leader
   held 100 ms on the card by device.slow): flight_executed 1-3, the rest
   coalesced, K1-K4 launched at most once per executed group, every
   answer byte-equal; then a follower with X-Request-Timeout 0.1 behind a
   leader held 600 ms: 504 at stage queue, the others 200, nothing owed at
   rest; (c) --cache-frame-mb 64: /resize then /crop on large.jpg, one
   decode, both byte-equal; (d) --transport-dct --transport-dct-egress
   --cache-frame-mb 64 --cache-device-mb 256 on phase 9's /resize of
   large.jpg five times: h2d bytes a request fall from the staged frame
   plus h, w and the dyns to those alone, device_hits grow, the resident
   bytes a frame, every answer bit-equal to the tier-off server's; the
   same on four lanes of card 0 with 16 clients over four sources
   (affinity_hits, device hits, bit-equal); a budget of 2.5 4K frames at
   k = 1 over three sources in turn (device_evictions, the budget held)
   and torch.cuda.memory_allocated falling by the tier's bytes when it is
   cleared; (e) memory.rss at critical on (d)'s server (with
   --cache-source-ttl 60 --pressure-rss-mb): device and source budgets 0,
   result and frame a quarter, pressure_shrinks 1, the resident frames
   freed, budgets restored at ok and the tier refilled; (f) config 1 over
   ?url= with --cache-source-ttl 60, five GETs: one origin GET carrying
   the first request's X-Request-ID, source_hits 4; (g) phase 6's mix on
   four lanes of card 0, every answer byte-equal to phase 6's.

17. the mesh: (a) config 5's stream (bench_firehose.py's `_gen_stream(32,
   seed=23)`, JPEG, PNG and WEBP from OpenCV) as /resize?width=300 from 16
   clients on three servers, unsharded, --use-mesh over four entries of
   card 0 and --mesh-policy sharded over the same: req/s, the mean batch,
   dispatches per entry and wire_bytes_by_device, every answer byte-equal
   across the three (the launches of their windows in the kernels line's
   `launches_mesh`); (b) `init_distributed` on the card with a world of
   one (nccl) and one all_reduce of a CUDA tensor; (c) two `python -m
   imaginary_tpu_torch --mesh-hosts 2` processes on card 0 (no collective:
   NCCL takes one rank per card), each answering config 1 byte-equal to
   the other and to phase 4.

18. the vector and HEIF/AVIF codecs: the loaders the machine has
   (librsvg, poppler-glib, libheif and its HEVC and AV1 encoders, Pillow's
   AVIF), then /resize and /info on button.svg, page.pdf and test.avif,
   type=avif and type=heif on large.jpg, a crafted inflate bomb and a
   self-referencing /Length PDF, each answer held to the reference's rule
   for the loaders found; K1's launches (`launches_vector`), the SVG's at
   C = 4.

19. the observability planes, on servers from the port's command line
   with config 2's batching: (a) with --wide-events, --slo-config,
   --enable-debug and --cost-attribution armed, 20 config 1 requests one
   at a time and one window of phase 6's mix, every answer byte-equal to
   phases 4 and 6, one wide event a request (placement device,
   cost_device_ms > 0), /health's slo, capacity (chip_busy, lanes,
   wait_split_ms, the bound_by verdict with device_ms_per_mb) and
   eventLoop blocks, /topz and the new /metrics families; (b)
   /debugz/profile?seconds=2 while config 1 runs: the exported trace's
   kernel events by name with their summed card ms, each of K2, K1, K4
   and K3 present by its symbol, a second capture meanwhile answering
   409; (c) config 1's p50 and p99 on the armed server against a server
   with none armed, in turns, and that server's /debugz and /topz 404;
   (d) with TLS on a self-signed certificate, config 1 over h2 and over
   HTTP/1.1 on one port, byte-equal (or why h2 was not driven: no
   libnghttp2, no curl with HTTP/2, no openssl); (e) --read-timeout 1: a
   stalled header read closed within 1-3 s and counted in /health's
   ingress block, a trickled body served, config 1 still served; (f) a
   server armed from IMAGINARY_TPU_FAILPOINTS (FAILPOINT_ENV_SPEC):
   /debugz/failpoints shows the spec and all 22 known sites, config 1
   answers the reference's 400 for the armed codec.encode error, phase 4's
   bytes after an empty PUT, and a boot with a bad spec exits non-zero. The
   plane's per-request device ms (the drain's wall share) is printed
   beside the profiler's card time a request. The launches of every
   request of the phase are the kernels line's `launches_obs`.

20. the single-host fleet: `python -m imaginary_tpu_torch.cli --workers 2
   --device cuda:0`, every worker a process with its own CUDA context on
   the card: (a) one process (`ServerProcess`) and then the two-worker
   fleet each take config 1 (20 one at a time on the fleet, one window of
   16 clients on each; req/s printed, no claim), every answer byte-equal
   to phase 4's; both workers' /health show cuda:0, K1-K4 launched and
   no host placement; nvidia-smi lists two contexts more than before the
   fleet (checked by pid where it names this namespace's pids), each
   worker maps the card and the supervisor neither maps it nor holds
   /dev/nvidia-uvm (it counts the cards through NVML); the card's used memory
   (cudaMemGetInfo) over this process's gives what a worker costs, and
   what --workers 0 would hold; (b) SIGHUP rolls both workers while
   config 1 runs one request at a time: every answer 200 and byte-equal,
   both epochs advanced; (c) a SIGKILLed worker comes back at a new
   epoch and answers byte-equal; (d) with --fleet-cache-mb 64
   --fleet-coherence --fleet-qos --fleet-admin-port, both workers warmed
   on other digests (a cold owner's first launch outlasts the hop's
   250 ms, and its sibling then runs locally): config 1 x 12
   launches K1-K4 once fleet-wide while both workers serve shm hits, 16
   digests move the forward hop's and the claims' counters, and /fleetz
   and the merged /metrics list both workers. The workers count their
   own launches: the kernels line's `launches_fleet` sums each worker
   incarnation's kernelLaunches as its /health last read them.

21. two hosts of the port on the one card (`multihost_phase`): two
   `--workers 2 --device cuda:0` supervisors, host-a and host-b, each
   with its admin plane and its own shm file, cross-pointed `--peers`,
   `--router`, `--peer-probe-interval 0.3`, `--fleet-cache-mb 64`,
   `--enable-debug`, a `--pressure-rss-mb` governor and a qos policy with
   a batch tenant; one process (`ServerProcess`) gives the answers they
   must equal. Once each admin plane's `/fleetz?scope=cluster` shows the
   other host alive and every worker has launched (requests pinned with
   `X-Imaginary-Route: local`; a cold worker's first launch outlasts the
   250 ms hop): (a) 32 config 1 variants (`/resize?width=W&height=200`)
   to A: every answer byte-equal and stamped with A's `id:epoch`, the
   B-owned ones (host rendezvous) forwarded (`forwards` > 0, none
   fenced), B's answer to each of them stamped with B's `id:epoch`, B's
   K1-K4 risen by at least the forwards, no worker placing work on the
   host; the p50 of a forwarded and of a local request (no claim) and the
   card's memory for the four contexts; (b) B's workers SIGKILLed with
   B-owned requests sent to A at once (the dial refused:
   `forward_fails` > 0), then B's supervisor: every answer from A 200 and
   byte-equal; (c) B started again on its ports: A's gossip reads a
   greater epoch and the forwards resume; (d) A held at the critical
   rung (`memory.rss=error` through /debugz/failpoints on each worker):
   its batch-class requests answer 200 from B (`spills`), then with B
   critical too, 503 with Retry-After and nothing more served by B. The
   kernels line's `launches_multihost` sums the one process's and every
   worker's launches.

It ends with the card's `nvidia-smi` name and power limit, one
`{"kernels": [...]}` line, and the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Details go to chip_smoke_out/chip_smoke.json.
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
LARGE_JPG = os.path.join(ROOT, "tests", "testdata", "large.jpg")
EXIF6_JPG = os.path.join(ROOT, "tests", "testdata", "exif-orient-6.jpg")
OUT_DIR = os.path.join(ROOT, "chip_smoke_out")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores (data sheet)
F32_TOL = 1e-3  # absolute, on the 0-255 scale
U8_TOL = 1  # LSB
SEED = 20261017
DEVICE = "cuda"

KERNEL_ROWS = {
    "resample": ("imaginary_tpu_torch/kernels/csrc/resample.cu",
                 "imaginary_tpu/ops/stages.py:46"),
    "yuv420_unpack": ("imaginary_tpu_torch/kernels/csrc/yuv420_unpack.cu",
                      "imaginary_tpu/ops/stages.py:403"),
    "yuv420_pack": ("imaginary_tpu_torch/kernels/csrc/yuv420_pack.cu",
                    "imaginary_tpu/ops/stages.py:521"),
    "gather": ("imaginary_tpu_torch/kernels/csrc/gather.cu",
               "imaginary_tpu/ops/stages.py:151"),
    "orient": ("imaginary_tpu_torch/kernels/csrc/orient.cu",
               "imaginary_tpu/ops/stages.py:201"),
    "blur": ("imaginary_tpu_torch/kernels/csrc/blur.cu",
             "imaginary_tpu/ops/stages.py:237"),
    "composite": ("imaginary_tpu_torch/kernels/csrc/composite.cu",
                  "imaginary_tpu/ops/stages.py:283"),
    "gray": ("imaginary_tpu_torch/kernels/csrc/gray.cu",
             "imaginary_tpu/ops/stages.py:625"),
    "saliency": ("imaginary_tpu_torch/kernels/csrc/saliency.cu",
                 "imaginary_tpu/ops/saliency.py:20"),
    "window_argmax": ("imaginary_tpu_torch/kernels/csrc/saliency.cu",
                      "imaginary_tpu/ops/saliency.py:55"),
    "from_dct": ("imaginary_tpu_torch/kernels/csrc/from_dct.cu",
                 "imaginary_tpu/ops/stages.py:425"),
    "to_dct": ("imaginary_tpu_torch/kernels/csrc/to_dct.cu",
               "imaginary_tpu/ops/stages.py:555"),
    "blur_halo": ("imaginary_tpu_torch/kernels/csrc/blur_halo.cu",
                  "imaginary_tpu/parallel/spatial.py:56"),
}
# The kernels each main path runs.
CONFIG1_KERNELS = ("resample", "yuv420_unpack", "yuv420_pack", "gather")
CONFIG2_KERNELS = CONFIG1_KERNELS + ("orient",)
# config 3's K4 stages are identity shrinks, which the chain drops; the bw
# /resize's K8 folds into its K3 (K8 runs on the spatial route's bw chain)
CONFIG3_KERNELS = ("resample", "yuv420_unpack", "yuv420_pack", "blur", "composite")
CONFIG4_KERNELS = ("resample", "gather", "saliency", "window_argmax")
DCT_KERNELS = ("from_dct", "to_dct")


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def call_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Median per-call time between CUDA events recorded around each call:
    what one call costs its caller, host launch overhead included (the
    card waits for the launch while the host runs the wrapper)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, calls: int = 10, reps: int = 5) -> float:
    """Device time per call: median over `reps` windows of `calls` calls
    queued behind a GPU sleep, so the card runs them back to back and the
    host's launch overhead stays hidden (warm L2, as on the path)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    # ~2e6 cycles per ms at the H100's boost clock; 3x the host's time to
    # enqueue the window, so the queue never runs dry inside it
    cycles = int(max(enqueue_ms, 0.05) * calls * 3 * 2e6)
    means = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        means.append(a.elapsed_time(b) / calls)
    return statistics.median(means)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item()) if a.numel() else 0.0


def bound_ms(nbytes: int, flops: float) -> tuple:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def k10_work(h: int, w: int, win_h: int, win_w: int, hb: int, wb: int, c0: int = 0,
             c1=None) -> tuple:
    """(bytes, operations) K10 needs for one image's candidates whose left
    lies in [c0, c1): the f32 integral image entries it reads once (rows
    [0, nr) and [win_h, win_h + nr) at the candidates' lefts and rights,
    nr = h - win_h + 1; column 0 is zeros and not read), its 8-byte
    answer, and 4 operations a candidate (3 subtractions, a compare)."""
    lim_t, lim_l = h - win_h, w - win_w
    nr = 0 if lim_t < 0 else min(lim_t, hb - 1) + 1
    ncols = 0 if lim_l < 0 else min(lim_l, wb - 1) + 1
    lefts = range(c0, min(ncols, wb if c1 is None else c1))
    if nr == 0 or not lefts:
        return 8, 0.0
    rows = len(set(range(nr)) | set(range(win_h, win_h + nr)))
    cols = set(lefts) | {min(lft + win_w, wb) for lft in lefts}
    cols.discard(0)
    return rows * len(cols) * 4 + 8, 4.0 * nr * len(lefts)


# --- phase 3: kernels against their plain versions --------------------------

def packed_inputs(codecs, bsz: int, shrink: int, hb: int, wb: int, rng):
    """B packed 4:2:0 buffers: large.jpg decoded at 1/shrink, then per-image
    seeded noise so the batch's images differ."""
    import numpy as np

    with open(LARGE_JPG, "rb") as f:
        buf = f.read()
    packed, h, w, _ = codecs.decode_yuv420(buf, shrink, hb, wb)
    out = []
    for i in range(bsz):
        if i == 0:
            out.append(np.array(packed))
            continue
        noise = rng.integers(-12, 13, size=packed.shape)
        out.append(np.clip(packed.astype(np.int32) + noise, 0, 255).astype(np.uint8))
    return np.stack(out), h, w


def check(name, got, want, results, case, tol):
    err = max_err(got, want)
    if not err <= tol:
        raise AssertionError(f"{name} [{case}]: max |err| {err} > {tol}")
    results.setdefault(name, {})[case] = {"max_abs_err": err}
    return err


def check_all(name, pairs, results, case, tol):
    """check() over several (got, want) pairs, keeping the largest error."""
    err = max(max_err(g, w) for g, w in pairs)
    if not err <= tol:
        raise AssertionError(f"{name} [{case}]: max |err| {err} > {tol}")
    results.setdefault(name, {})[case] = {"max_abs_err": err}
    return err


def kernel_phase(rng) -> dict:
    import torch

    from imaginary_tpu_torch import codecs, kernels
    from imaginary_tpu_torch.kernels import reference

    dev = torch.device(DEVICE)
    res: dict = {}

    def i32(v, b):
        return torch.full((b,), v, dtype=torch.int32, device=dev)

    def f32(v, b):
        return torch.full((b,), float(v), dtype=torch.float32, device=dev)

    # main path: FromYuv420(320,512) -> Sample(192,320){169x300}
    #   -> Embed(208,304,COPY){off_y 15} -> ToYuv420(208,304);
    # crop: Sample(256,384){200x356} -> Extract(208,304){left 28}
    hb, wb = 320, 512
    for case, bsz in (("B1", 1), ("B16", 16)):
        np_packed, h, w = packed_inputs(codecs, bsz, 4, hb, wb, rng)
        x2 = torch.from_numpy(np_packed).to(dev)
        hh, ww = i32(h, bsz), i32(w, bsz)
        rgb = kernels.yuv420_to_rgb(x2, hh, ww, hb, wb)
        rgb_ref = reference.yuv420_to_rgb(x2, hh, ww, hb, wb)
        check("yuv420_unpack", rgb, rgb_ref, res, case, F32_TOL)
        timing(res, "yuv420_unpack", case,
               lambda: kernels.yuv420_to_rgb(x2, hh, ww, hb, wb),
               lambda: reference.yuv420_to_rgb(x2, hh, ww, hb, wb), None,
               x2.numel() + rgb.numel() * 4, 30.0 * rgb.numel() / 3)

        for variant, (ohb, owb, dh, dw) in (("resize", (192, 320, 169, 300)),
                                            ("crop", (256, 384, 200, 356))):
            dst_h, dst_w = f32(dh, bsz), f32(dw, bsz)
            out, oh, ow = kernels.resample(rgb_ref, hh, ww, dst_h, dst_w, ohb, owb, "lanczos3")
            ref, _, _ = reference.resample(rgb_ref, hh, ww, dst_h, dst_w, ohb, owb, "lanczos3")
            if not (torch.equal(oh.cpu(), torch.full((bsz,), dh, dtype=torch.int32))
                    and torch.equal(ow.cpu(), torch.full((bsz,), dw, dtype=torch.int32))):
                raise AssertionError("resample output dims wrong")
            check("resample", out, ref, res, f"{case}-{variant}", F32_TOL)
            wy = reference.sample_matrix(ohb, hb, hh, dst_h, "lanczos3")
            wx = reference.sample_matrix(owb, wb, ww, dst_w, "lanczos3")
            flops = 2.0 * (float((wy != 0).sum()) * wb * 3 + float((wx != 0).sum()) * ohb * 3)
            xin = rgb_ref

            def lib(xin=xin, wy=wy, wx=wx, ohb=ohb, bsz=bsz):
                t = torch.bmm(wy, xin.reshape(bsz, hb, wb * 3)).view(bsz, ohb, wb, 3)
                return torch.matmul(wx[:, None], t)

            if max_err(lib(), ref) > F32_TOL:
                raise AssertionError("library resample disagrees with the plain version")
            timing(res, "resample", f"{case}-{variant}",
                   lambda: kernels.resample(xin, hh, ww, dst_h, dst_w, ohb, owb, "lanczos3"),
                   lambda: reference.resample(xin, hh, ww, dst_h, dst_w, ohb, owb, "lanczos3"),
                   lib, xin.numel() * 4 + out.numel() * 4, flops)

            if variant == "resize":
                off_y, off_x = i32(15, bsz), i32(0, bsz)
                ch, cw = i32(200, bsz), i32(300, bsz)
                args = (208, 304, off_y, off_x, oh, ow, "clamp")
                g = kernels.gather(ref, *args)
                g_ref = reference.gather(ref, *args)
                check("gather", g, g_ref, res, f"{case}-embed", 0.0)
                timing(res, "gather", f"{case}-embed",
                       lambda: kernels.gather(ref, *args),
                       lambda: reference.gather(ref, *args), None,
                       ref.numel() * 4 + g.numel() * 4, 0.0)
                y = kernels.rgb_to_yuv420(g_ref, ch, cw, 208, 304)
                y_ref = reference.rgb_to_yuv420(g_ref, ch, cw, 208, 304)
                check("yuv420_pack", y, y_ref, res, case, U8_TOL)
                timing(res, "yuv420_pack", case,
                       lambda: kernels.rgb_to_yuv420(g_ref, ch, cw, 208, 304),
                       lambda: reference.rgb_to_yuv420(g_ref, ch, cw, 208, 304), None,
                       g_ref.numel() * 4 + y.numel(), 20.0 * g_ref.numel() / 3)
                # the other gather modes, at the same shapes
                margs = (208, 304, off_y, off_x, oh, ow, "mirror")
                check("gather", kernels.gather(ref, *margs),
                      reference.gather(ref, *margs), res, f"{case}-mirror", 0.0)
                fill = torch.full((bsz, 3), 255.0, device=dev)
                check("gather", kernels.gather(ref, *args, fill=fill),
                      reference.gather(ref, *args, fill=fill), res,
                      f"{case}-fill", 0.0)
            else:
                top, left = i32(0, bsz), i32(28, bsz)
                g = kernels.gather(ref, 208, 304, top, left, mode="window")
                g_ref = reference.gather(ref, 208, 304, top, left, mode="window")
                check("gather", g, g_ref, res, f"{case}-extract", 0.0)

    # full 1080p, no shrink-on-load: K2 on [8,1632,1920,1], K1 from
    # [8,1088,1920,3] to the 300-wide target (169x300 in a 192x320 bucket)
    bsz, hb, wb = 8, 1088, 1920
    np_packed, h, w = packed_inputs(codecs, bsz, 1, hb, wb, rng)
    x2 = torch.from_numpy(np_packed).to(dev)
    hh, ww = i32(h, bsz), i32(w, bsz)
    rgb = kernels.yuv420_to_rgb(x2, hh, ww, hb, wb)
    rgb_ref = reference.yuv420_to_rgb(x2, hh, ww, hb, wb)
    check("yuv420_unpack", rgb, rgb_ref, res, "1080p-B8", F32_TOL)
    timing(res, "yuv420_unpack", "1080p-B8",
           lambda: kernels.yuv420_to_rgb(x2, hh, ww, hb, wb),
           lambda: reference.yuv420_to_rgb(x2, hh, ww, hb, wb), None,
           x2.numel() + rgb.numel() * 4, 30.0 * rgb.numel() / 3)
    del rgb
    dst_h, dst_w = f32(169, bsz), f32(300, bsz)
    out, _, _ = kernels.resample(rgb_ref, hh, ww, dst_h, dst_w, 192, 320, "lanczos3")
    ref, _, _ = reference.resample(rgb_ref, hh, ww, dst_h, dst_w, 192, 320, "lanczos3")
    check("resample", out, ref, res, "1080p-B8", F32_TOL)
    wy = reference.sample_matrix(192, hb, hh, dst_h, "lanczos3")
    wx = reference.sample_matrix(320, wb, ww, dst_w, "lanczos3")
    flops = 2.0 * (float((wy != 0).sum()) * wb * 3 + float((wx != 0).sum()) * 192 * 3)

    def lib1080():
        t = torch.bmm(wy, rgb_ref.reshape(bsz, hb, wb * 3)).view(bsz, 192, wb, 3)
        return torch.matmul(wx[:, None], t)

    timing(res, "resample", "1080p-B8",
           lambda: kernels.resample(rgb_ref, hh, ww, dst_h, dst_w, 192, 320, "lanczos3"),
           lambda: reference.resample(rgb_ref, hh, ww, dst_h, dst_w, 192, 320, "lanczos3"),
           lib1080, rgb_ref.numel() * 4 + out.numel() * 4, flops)
    # nearest at 2x and 1/2 (exact-tie sensitive), the other kernels once
    small = rgb_ref[:2, :64, :96].contiguous()
    sh, sw = i32(64, 2), i32(96, 2)
    for kind, (dh, dw, ohb, owb) in (("nearest", (128, 192, 128, 192)),
                                    ("nearest", (32, 48, 32, 48)),
                                    ("lanczos2", (50, 70, 64, 96)),
                                    ("cubic", (100, 150, 128, 192)),
                                    ("linear", (40, 60, 48, 64))):
        a = f32(dh, 2), f32(dw, 2)
        check("resample", kernels.resample(small, sh, sw, *a, ohb, owb, kind)[0],
              reference.resample(small, sh, sw, *a, ohb, owb, kind)[0], res,
              f"{kind}-{dh}x{dw}", F32_TOL)
    return res


# (mode, image shape): the /rotate chain's 1080p buckets; rotate=90 is a
# transpose of [1152, 2048] then a flop of [2048, 1152], rotate=180 a flip
# then a flop of [1152, 2048]
ORIENT_CASES = (("transpose", (1152, 2048, 3)), ("flop", (2048, 1152, 3)),
                ("flip", (1152, 2048, 3)))
ORIENT_BATCHES = (1, 32)
ORIENT_FRAMES = ((1, 1088, 1920, 3), (32, 1088, 1920, 3))  # the 1080p frame, f32
ORIENT_U8 = (4, 1088, 1920, 4)  # uint8 input (the RGB transport's first stage)
# the runs of orientation stages K5 launches as one (rotate=90, 180 and
# 270, and EXIF 7's three stages) on the /rotate chain's 1080p bucket
ORIENT_RUNS = (("rotate90", ("transpose", "flop")), ("rotate180", ("flip", "flop")),
               ("rotate270", ("transpose", "flip")),
               ("exif7", ("transpose", "flip", "flop")))
ORIENT_RUN_SHAPE = (1152, 2048, 3)
# what the kernels line gives of each folded run at B = 32
RUN_KEYS = ("ms", "plain_ms", "bound_ms", "unfolded_launches", "unfolded_ms")
# K5's W-shard forms over four shards of the 4K JPEG's f32 [1, 2176, 3840,
# 3] K2 output: the flop's windows and the flip's own columns (/flop and
# /flip), and the transpose's row bands (/rotate)
ORIENT_4K = (1, 2176, 3840, 3)
ORIENT_SHARDS = 4
SHRINK_IN, SHRINK_OUT = (2048, 1152, 3), (1920, 1088)  # /rotate's bucket shrink
ROTATE_IN_BUCKET = (1152, 2048)  # /rotate's decode bucket (K2's RGB output)
CONFIG2_BATCH = 32


def valid_dims(bsz: int, hb: int, wb: int, dev):
    """Per-image valid dims that differ inside the batch: the 1080p frame
    (its long side along the bucket's long side) minus a few pixels per
    image, so every image has its own padding."""
    import torch

    base_h, base_w = (1080, 1920) if hb <= wb else (1920, 1080)
    i = torch.arange(bsz, dtype=torch.int32, device=dev)
    h = torch.clamp(min(hb, base_h) - 2 * i, min=1).to(torch.int32)
    w = torch.clamp(min(wb, base_w) - 4 * i, min=1).to(torch.int32)
    return h, w


def orient_phase(res: dict) -> None:
    """K5 against its plain version, exact, and timed at the /rotate
    chain's shapes, one stage a launch; the library call for the transpose
    is permute(0, 2, 1, 3).contiguous(). Flip and flop inside per-image
    valid dims have no single PyTorch call, so their library_ms is null.
    Then the runs of stages as one launch and the W-shard forms
    (`orient_runs_phase`)."""
    import torch

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.kernels import reference

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for bsz in ORIENT_BATCHES:
        for mode, shape in ORIENT_CASES:
            case = f"B{bsz}-{mode}"
            x = torch.rand((bsz, *shape), generator=gen, device=dev) * 255.0
            h, w = valid_dims(bsz, shape[0], shape[1], dev)
            got = kernels.orient(x, h, w, mode)
            want = reference.orient(x, h, w, mode)
            check("orient", got, want, res, case, 0.0)
            lib = None
            if mode == "transpose":
                def lib(x=x):
                    return x.permute(0, 2, 1, 3).contiguous()

                if not torch.equal(lib(), want):
                    raise AssertionError("library transpose disagrees with the plain version")
            timing(res, "orient", case,
                   lambda x=x, h=h, w=w, mode=mode: kernels.orient(x, h, w, mode),
                   lambda x=x, h=h, w=w, mode=mode: reference.orient(x, h, w, mode),
                   lib, x.numel() * 4 + got.numel() * 4, 0.0)
            del x, got, want
    for mode, _ in ORIENT_CASES:
        for frame in ORIENT_FRAMES:
            bsz, hb, wb, c = frame
            x = torch.rand(frame, generator=gen, device=dev) * 255.0
            h, w = valid_dims(bsz, hb, wb, dev)
            check("orient", kernels.orient(x, h, w, mode), reference.orient(x, h, w, mode),
                  res, f"frame-B{bsz}-{mode}", 0.0)
        bsz, hb, wb, c = ORIENT_U8
        xu = torch.randint(0, 256, ORIENT_U8, generator=gen, device=dev, dtype=torch.uint8)
        h, w = valid_dims(bsz, hb, wb, dev)
        for out_u8 in (False, True):
            check("orient", kernels.orient(xu, h, w, mode, out_u8),
                  reference.orient(xu, h, w, mode, out_u8), res,
                  f"u8-{'u8' if out_u8 else 'f32'}-{mode}", 0.0)
        del x, xu
    log("  orient: flip and flop have no single-call library equivalent "
        "(mirror inside per-image valid dims): library_ms null")
    orient_runs_phase(res, gen)
    # K4's window at no offset on /rotate: the flopped [B, 2048, 1152, 3]
    # sliced to the [B, 1920, 1088, 3] output bucket; one library call
    # computes the same function
    for bsz in ORIENT_BATCHES:
        x = torch.rand((bsz, *SHRINK_IN), generator=gen, device=dev) * 255.0
        ohb, owb = SHRINK_OUT
        got = kernels.gather(x, ohb, owb, mode="window")
        want = reference.gather(x, ohb, owb, mode="window")
        check("gather", got, want, res, f"B{bsz}-shrink", 0.0)

        def lib(x=x):
            return x[:, :ohb, :owb].contiguous()

        if not torch.equal(lib(), want):
            raise AssertionError("library slice disagrees with the plain shrink")
        # the window reads only the output's pixels of x: bytes of the
        # output read once and written once
        timing(res, "gather", f"B{bsz}-shrink",
               lambda x=x: kernels.gather(x, ohb, owb, mode="window"),
               lambda x=x: reference.gather(x, ohb, owb, mode="window"),
               lib, got.numel() * 4 * 2, 0.0)
        del x, got, want


def orient_runs_phase(res: dict, gen) -> None:
    """K5's folded runs (ORIENT_RUNS) at ORIENT_BATCHES on the /rotate
    chain's bucket, each exact against its plain version and against this
    tree's single modes launched one after the other (the unfolded chain),
    timed beside both; the runs in uint8 in and out; the W-shard forms at
    the 4K shards (ORIENT_4K) beside the whole-image kernel."""
    import torch

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.kernels import reference

    dev = torch.device(DEVICE)

    def unfolded(x, h, w, names):
        for m in names:
            x = kernels.orient(x, h, w, m)
            if m == "transpose":
                h, w = w, h
        return x

    for bsz in ORIENT_BATCHES:
        x = torch.rand((bsz, *ORIENT_RUN_SHAPE), generator=gen, device=dev) * 255.0
        h, w = valid_dims(bsz, *ORIENT_RUN_SHAPE[:2], dev)
        for name, names in ORIENT_RUNS:
            case = f"B{bsz}-{name}"
            got = kernels.orient_run(x, h, w, names)
            check("orient", got, reference.orient_run(x, h, w, names), res, case, 0.0)
            if not torch.equal(got, unfolded(x, h, w, names)):
                raise AssertionError(f"orient [{case}]: the run differs from its stages")
            timing(res, "orient", case,
                   lambda x=x, h=h, w=w, names=names: kernels.orient_run(x, h, w, names),
                   lambda x=x, h=h, w=w, names=names: reference.orient_run(x, h, w, names),
                   None, x.numel() * 4 + got.numel() * 4, 0.0)
            row = res["orient"][case]
            row["unfolded_launches"] = len(names)
            row["unfolded_ms"] = device_ms(lambda x=x, h=h, w=w, names=names:
                                           unfolded(x, h, w, names))
            log(f"  orient         {case:16s} {len(names)} stages as one launch "
                f"{row['ms']:.4f} ms, unfolded {row['unfolded_ms']:.4f} ms "
                f"(bound {row['bound_ms']:.4f} ms)")
            del got
        del x
    bsz, hb, wb, c = ORIENT_U8
    xu = torch.randint(0, 256, ORIENT_U8, generator=gen, device=dev, dtype=torch.uint8)
    h, w = valid_dims(bsz, hb, wb, dev)
    for name, names in ORIENT_RUNS:
        for out_u8 in (False, True):
            check("orient", kernels.orient_run(xu, h, w, names, out_u8),
                  reference.orient_run(xu, h, w, names, out_u8), res,
                  f"u8-{'u8' if out_u8 else 'f32'}-{name}", 0.0)
    del xu
    # the W-shard forms: shard j of n owns output columns [j lw, (j + 1) lw)
    x = torch.rand(ORIENT_4K, generator=gen, device=dev) * 255.0
    one, hb, wb, c = ORIENT_4K
    h = torch.tensor([2160], dtype=torch.int32, device=dev)
    w = torch.tensor([wb], dtype=torch.int32, device=dev)
    n = ORIENT_SHARDS
    lw = wb // n
    # /flop: shard j's window is the mirrored input columns [wb - (j + 1) lw,
    # wb - j lw), its first column in_col0
    wins = [(x[:, :, wb - (j + 1) * lw:wb - j * lw].contiguous(), j * lw, wb - (j + 1) * lw)
            for j in range(n)]
    cols = [x[:, :, j * lw:(j + 1) * lw].contiguous() for j in range(n)]
    bands = [x[:, j * (hb // n):(j + 1) * (hb // n)].contiguous() for j in range(n)]
    forms = {
        "shard-flop": (lambda: [kernels.flop_shard(xs, h, w, c0, lw, k0) for xs, c0, k0 in wins],
                       lambda: [reference.flop_shard(xs, h, w, c0, lw, k0)
                                for xs, c0, k0 in wins],
                       lambda: kernels.orient(x, h, w, "flop"), torch.cat),
        "shard-flip": (lambda: [kernels.orient(xs, h, w, "flip") for xs in cols],
                       lambda: [reference.orient(xs, h, w, "flip") for xs in cols],
                       lambda: kernels.orient(x, h, w, "flip"), torch.cat),
        "shard-transpose": (lambda: [kernels.orient(b, h, w, "transpose") for b in bands],
                            lambda: [reference.orient(b, h, w, "transpose") for b in bands],
                            lambda: kernels.orient(x, h, w, "transpose"), torch.cat),
    }
    for case, (fn, plain, whole, cat) in forms.items():
        got = fn()
        check_all("orient", list(zip(got, plain())), res, f"4K-{case}", 0.0)
        if not torch.equal(cat(got, dim=2), whole()):
            raise AssertionError(f"orient [4K-{case}]: the shards differ from the whole kernel")
        timing(res, "orient", f"4K-{case}", fn, plain, None, x.numel() * 8, 0.0)
        row = res["orient"][f"4K-{case}"]
        row["shards"] = n
        row["whole_ms"] = device_ms(whole)
        log(f"  orient         4K-{case:13s} {n} shards {row['ms']:.4f} ms, the whole kernel "
            f"{row['whole_ms']:.4f} ms (bound {row['bound_ms']:.4f} ms)")
        del got
    del x, wins, cols, bands


def config2_kernel_phase(rng, res: dict) -> None:
    """K1, K2 and K3 at the shapes config 2's chains give them at B=32:
    /rotate's K2 on the 1080p packed bucket and K3 on the rotated
    [B, 1920, 1088, 3] output bucket, and /thumbnail's K1 (its K2 and
    K3 shapes are config 1's, held in kernel_phase)."""
    import torch

    from imaginary_tpu_torch import codecs, kernels
    from imaginary_tpu_torch.kernels import reference

    dev = torch.device(DEVICE)
    bsz = CONFIG2_BATCH
    hb, wb = ROTATE_IN_BUCKET
    np_packed, h, w = packed_inputs(codecs, bsz, 1, hb, wb, rng)
    x2 = torch.from_numpy(np_packed).to(dev)
    del np_packed
    hh = torch.full((bsz,), h, dtype=torch.int32, device=dev)
    ww = torch.full((bsz,), w, dtype=torch.int32, device=dev)
    rgb = kernels.yuv420_to_rgb(x2, hh, ww, hb, wb)
    rgb_ref = reference.yuv420_to_rgb(x2, hh, ww, hb, wb)
    case = f"B{bsz}-rotate"
    check("yuv420_unpack", rgb, rgb_ref, res, case, F32_TOL)
    timing(res, "yuv420_unpack", case,
           lambda: kernels.yuv420_to_rgb(x2, hh, ww, hb, wb),
           lambda: reference.yuv420_to_rgb(x2, hh, ww, hb, wb), None,
           x2.numel() + rgb.numel() * 4, 30.0 * rgb.numel() / 3)
    del x2, rgb
    # K3 on the rotated, flopped and shrunk frame: [B, 1920, 1088, 3]
    # holding 1920x1080 valid pixels
    ohb, owb = SHRINK_OUT
    t = rgb_ref.transpose(1, 2)[:, :ohb, :owb].contiguous()
    del rgb_ref
    ch = torch.full((bsz,), w, dtype=torch.int32, device=dev)
    cw = torch.full((bsz,), h, dtype=torch.int32, device=dev)
    y = kernels.rgb_to_yuv420(t, ch, cw, ohb, owb)
    y_ref = reference.rgb_to_yuv420(t, ch, cw, ohb, owb)
    check("yuv420_pack", y, y_ref, res, case, U8_TOL)
    timing(res, "yuv420_pack", case,
           lambda: kernels.rgb_to_yuv420(t, ch, cw, ohb, owb),
           lambda: reference.rgb_to_yuv420(t, ch, cw, ohb, owb), None,
           t.numel() * 4 + y.numel(), 20.0 * t.numel() / 3)
    del t, y, y_ref
    # /thumbnail: K1 from the 1/4 decode's [B, 320, 512, 3] bucket to
    # 200x300 in a [B, 208, 304, 3] bucket
    hb, wb = 320, 512
    np_packed, h, w = packed_inputs(codecs, bsz, 4, hb, wb, rng)
    x2 = torch.from_numpy(np_packed).to(dev)
    hh = torch.full((bsz,), h, dtype=torch.int32, device=dev)
    ww = torch.full((bsz,), w, dtype=torch.int32, device=dev)
    xin = reference.yuv420_to_rgb(x2, hh, ww, hb, wb)
    ohb, owb = 208, 304
    dst_h = torch.full((bsz,), 200.0, device=dev)
    dst_w = torch.full((bsz,), 300.0, device=dev)
    out, _, _ = kernels.resample(xin, hh, ww, dst_h, dst_w, ohb, owb, "lanczos3")
    ref, _, _ = reference.resample(xin, hh, ww, dst_h, dst_w, ohb, owb, "lanczos3")
    case = f"B{bsz}-thumbnail"
    check("resample", out, ref, res, case, F32_TOL)
    wy = reference.sample_matrix(ohb, hb, hh, dst_h, "lanczos3")
    wx = reference.sample_matrix(owb, wb, ww, dst_w, "lanczos3")
    flops = 2.0 * (float((wy != 0).sum()) * wb * 3 + float((wx != 0).sum()) * ohb * 3)

    def lib():
        t = torch.bmm(wy, xin.reshape(bsz, hb, wb * 3)).view(bsz, ohb, wb, 3)
        return torch.matmul(wx[:, None], t)

    if max_err(lib(), ref) > F32_TOL:
        raise AssertionError("library resample disagrees with the plain version")
    timing(res, "resample", case,
           lambda: kernels.resample(xin, hh, ww, dst_h, dst_w, ohb, owb, "lanczos3"),
           lambda: reference.resample(xin, hh, ww, dst_h, dst_w, ohb, owb, "lanczos3"),
           lib, xin.numel() * 4 + out.numel() * 4, flops)


# config 3's chain after K1: f32 [B, 736, 1280, 3] holding 720x1280
CONFIG3_BATCHES = (1, 8)
CONFIG3_FRAME = (736, 1280)
CONFIG3_VALID = (720, 1280)
CONFIG3_SRC = (2160, 3840)  # the 4K PNG, in its [2560, 4096] bucket
CONFIG3_SRC_BUCKET = (2560, 4096)
CONFIG3_BLOCK = (24, 48)  # the "bench" text watermark's block bucket
BW_FRAME = (368, 640)  # the colorspace=bw /resize: K8 after K1 at 1/2 decode
BW_VALID = (360, 640)
K1_NARROW = (450, 800)  # /resize?width=800 of the 4K PNG: a [464, 800] bucket


def blur_flops(h, w, r: int, c: int) -> float:
    """Flops that K6's function needs for these valid dims: per valid
    element 2 per vertical tap, 2 per horizontal tap and 2 for the
    normalisation by rowden[y] * colden[x]; per image one add per tap of
    each valid row's rowden and each valid column's colden. The tap loops
    are clipped to the valid region."""
    import numpy as np

    def taps(n):
        i = np.arange(n)
        return int((np.minimum(r, n - 1 - i) - np.maximum(-r, -i) + 1).sum())

    total = 0.0
    for hh, ww in zip(h.tolist(), w.tolist()):
        th, tw = taps(hh), taps(ww)
        total += c * (2.0 * ww * th + 2.0 * hh * tw + 2.0 * hh * ww) + th + tw
    return total


def config3_dims(bsz: int, dev):
    """Per-image valid dims and sigma that differ inside the batch, none a
    multiple of the block: config 3's 720x1280 minus a few pixels each."""
    import torch

    i = torch.arange(bsz, dtype=torch.int32, device=dev)
    h = (CONFIG3_VALID[0] - 3 * i).to(torch.int32)
    w = (CONFIG3_VALID[1] - 5 * i).to(torch.int32)
    sigma = (1.2 + 0.25 * i).to(torch.float32)
    return h, w, sigma


def config3_kernel_phase(res: dict) -> None:
    """K6, K7 and K8 against their plain versions at config 3's shapes,
    and K1 on the 4K PNG's uint8 bucket. No single PyTorch call computes
    K6 (per-image taps and a normalisation by the masked tap sums) or K7
    (a per-image floored-modulo tile or placement, then the blend), so
    their library_ms is null; K8's library call is a matmul by the luma
    matrix, and K1's the bmm + matmul over the sampling matrices."""
    import torch

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.kernels import reference
    from imaginary_tpu_torch.ops.plan import plan_operation
    from imaginary_tpu_torch.params import build_params_from_query

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    hb, wb = CONFIG3_FRAME
    for bsz in CONFIG3_BATCHES:
        x = torch.rand((bsz, hb, wb, 3), generator=gen, device=dev) * 255.0
        h, w, sigma = config3_dims(bsz, dev)
        case = f"B{bsz}-r4"
        got = kernels.blur(x, h, w, sigma, 4)
        check("blur", got, reference.blur(x, h, w, sigma, 4), res, case, F32_TOL)
        timing(res, "blur", case,
               lambda x=x, h=h, w=w, s=sigma: kernels.blur(x, h, w, s, 4),
               lambda x=x, h=h, w=w, s=sigma: reference.blur(x, h, w, s, 4), None,
               x.numel() * 4 + got.numel() * 4, blur_flops(h, w, 4, 3))
        del x, got
    x = torch.rand((1, hb, wb, 3), generator=gen, device=dev) * 255.0
    h, w, _ = config3_dims(1, dev)
    for case, r, sig in (("B1-r64", 64, 20.0), ("B1-sigma0", 4, 0.0)):
        sigma = torch.full((1,), sig, device=dev)
        got = kernels.blur(x, h, w, sigma, r)
        check("blur", got, reference.blur(x, h, w, sigma, r), res, case, F32_TOL)
        timing(res, "blur", case,
               lambda r=r, s=sigma: kernels.blur(x, h, w, s, r),
               lambda r=r, s=sigma: reference.blur(x, h, w, s, r), None,
               x.numel() * 4 + got.numel() * 4, blur_flops(h, w, r, 3))
    # /blur on a PNG: uint8 in (the chain's first stage); and a uint8 out
    xu = torch.randint(0, 256, (1, hb, wb, 4), generator=gen, device=dev, dtype=torch.uint8)
    sigma = torch.full((1,), 1.2, device=dev)
    check("blur", kernels.blur(xu, h, w, sigma, 4), reference.blur(xu, h, w, sigma, 4),
          res, "B1-u8-in-C4", F32_TOL)
    check("blur", kernels.blur(xu, h, w, sigma, 4, True),
          reference.blur(xu, h, w, sigma, 4, True), res, "B1-u8-in-out-C4", U8_TOL)

    # K7: the text block tiled from (top, left) past the block's size, and
    # placed so that it overhangs the valid region and the bucket
    bhb, bwb = CONFIG3_BLOCK
    for c in (3, 4):
        for mode in ("replicate", "placed"):
            for bsz in (CONFIG3_BATCHES if (c, mode) == (3, "replicate") else (1,)):
                x = torch.rand((bsz, hb, wb, c), generator=gen, device=dev) * 255.0
                ovl = torch.rand((bsz, bhb, bwb, 4), generator=gen, device=dev) * 255.0
                i = torch.arange(bsz, dtype=torch.int32, device=dev)
                top = (29 + 37 * i if mode == "replicate" else 700 + i).to(torch.int32)
                left = (61 + 11 * i if mode == "replicate" else 1250 - 3 * i).to(torch.int32)
                bh = torch.full((bsz,), 19, dtype=torch.int32, device=dev)
                bw = (43 + i).to(torch.int32)
                op = torch.full((bsz,), 0.5, device=dev)
                args = (x, ovl, top, left, op, bh, bw, mode == "replicate")
                case = f"B{bsz}-{mode}-C{c}"
                got = kernels.composite(*args)
                check("composite", got, reference.composite(*args), res, case, F32_TOL)
                check("composite", kernels.composite(*args, out_u8=True),
                      reference.composite(*args, out_u8=True), res, case + "-u8", U8_TOL)
                if c == 3 and mode == "replicate":
                    timing(res, "composite", case,
                           lambda a=args: kernels.composite(*a),
                           lambda a=args: reference.composite(*a), None,
                           x.numel() * 4 + ovl.numel() * 4 + got.numel() * 4,
                           12.0 * bsz * hb * wb)
                del x, got
    # K7's placed form at phase 12(b)'s /watermarkimage: K2's f32 1080p
    # frame, the 240x96 mark placed once (clamped to the right edge)
    composite_placed_case(res, gen)

    # K8: uint8 in and out at config 3's frame (C = 3 and 4), and f32 at
    # the colorspace=bw /resize's shape, where one matmul by the luma
    # matrix computes the same function
    for c in (3, 4):
        xu = torch.randint(0, 256, (1, hb, wb, c), generator=gen, device=dev, dtype=torch.uint8)
        check("gray", kernels.gray(xu, True), reference.gray(xu, True), res,
              f"B1-u8-C{c}", U8_TOL)
    x = torch.rand((1, *BW_FRAME, 3), generator=gen, device=dev) * 255.0
    got = kernels.gray(x)
    check("gray", got, reference.gray(x), res, "bw-route", F32_TOL)
    luma = torch.tensor([0.2126, 0.7152, 0.0722], device=dev)[:, None].expand(3, 3).contiguous()

    def lib_gray(x=x):
        return torch.matmul(x, luma)

    if max_err(lib_gray(), got) > F32_TOL:
        raise AssertionError("library gray disagrees with the plain version")
    timing(res, "gray", "bw-route", lambda: kernels.gray(x), lambda: reference.gray(x),
           lib_gray, x.numel() * 4 + got.numel() * 4, 5.0 * x.numel() / 3)

    # K1 at config 3's first stage: uint8 [1, 2560, 4096, 3] holding the
    # 2160x3840 PNG, to 720x1280 in the [1, 736, 1280, 3] bucket (a 3x
    # downscale, cast fused)
    shb, swb = CONFIG3_SRC_BUCKET
    xs = torch.zeros((1, shb, swb, 3), dtype=torch.uint8, device=dev)
    xs[:, :CONFIG3_SRC[0], :CONFIG3_SRC[1]] = torch.randint(
        0, 256, (1, *CONFIG3_SRC, 3), generator=gen, device=dev, dtype=torch.uint8)
    sh = torch.full((1,), CONFIG3_SRC[0], dtype=torch.int32, device=dev)
    sw = torch.full((1,), CONFIG3_SRC[1], dtype=torch.int32, device=dev)
    dst_h = torch.full((1,), float(CONFIG3_VALID[0]), device=dev)
    dst_w = torch.full((1,), float(CONFIG3_VALID[1]), device=dev)
    out, _, _ = kernels.resample(xs, sh, sw, dst_h, dst_w, hb, wb, "lanczos3")
    ref, _, _ = reference.resample(xs, sh, sw, dst_h, dst_w, hb, wb, "lanczos3")
    check("resample", out, ref, res, "config3-4K-u8", F32_TOL)
    wy = reference.sample_matrix(hb, shb, sh, dst_h, "lanczos3")
    wx = reference.sample_matrix(wb, swb, sw, dst_w, "lanczos3")
    flops = 2.0 * (float((wy != 0).sum()) * swb * 3 + float((wx != 0).sum()) * hb * 3)

    def lib4k():
        t = torch.bmm(wy, xs.float().reshape(1, shb, swb * 3)).view(1, hb, swb, 3)
        return torch.matmul(wx[:, None], t)

    if max_err(lib4k(), ref) > F32_TOL:
        raise AssertionError("library resample disagrees with the plain version")
    timing(res, "resample", "config3-4K-u8",
           lambda: kernels.resample(xs, sh, sw, dst_h, dst_w, hb, wb, "lanczos3"),
           lambda: reference.resample(xs, sh, sw, dst_h, dst_w, hb, wb, "lanczos3"),
           lib4k, xs.numel() + out.numel() * 4, flops)
    # K1's W-shard form (the spatial route's first stage) on the same
    # frame over SPATIAL_SHARDS: each shard's input window alone, against
    # the shard form's plain version and, bit for bit, the whole launch
    n = SPATIAL_SHARDS
    lw = wb // n
    windows = [kernels.resample_window("lanczos3", CONFIG3_SRC[1], float(CONFIG3_VALID[1]),
                                       swb, wb, j * lw, (j + 1) * lw) for j in range(n)]
    parts = [xs[:, :, k0:k1].contiguous() for k0, k1 in windows]

    def shard_k1(fn):
        return [fn(parts[j], sh, sw, dst_h, dst_w, hb, wb, "lanczos3",
                   cols=(j * lw, (j + 1) * lw), in_col0=windows[j][0], in_wb=swb)[0]
                for j in range(n)]

    got = shard_k1(kernels.resample)
    case = f"config3-4K-u8-{n}shards"
    check_all("resample", list(zip(got, shard_k1(reference.resample))), res, case, F32_TOL)
    if not all(torch.equal(g, out[:, :, j * lw:(j + 1) * lw]) for j, g in enumerate(got)):
        raise AssertionError("K1's shard form differs from the whole launch")
    timing(res, "resample", case, lambda: shard_k1(kernels.resample),
           lambda: shard_k1(reference.resample), None,
           sum(p.numel() for p in parts) + out.numel() * 4, flops)
    log(f"  K1 shard form: {n} shards of {lw} columns, input windows {windows}, "
        f"each bit-equal to the whole launch's columns")
    # the same frame to K1_NARROW's width, whose shards are not a whole
    # number of 32-column tiles: a shard's last tile overhangs its columns
    # (which take no taps, so it reads only the staged window)
    k1 = plan_operation("resize", build_params_from_query({"width": str(K1_NARROW[1])}),
                        *CONFIG3_SRC, 1, 3).spec_key()[0]
    nhb, nwb = k1.out_hb, k1.out_wb
    nlw = nwb // n
    if nwb % n or nlw % 32 == 0:
        raise AssertionError(f"K1_NARROW's bucket width {nwb} must split into "
                             f"{n} shards of a width that 32 does not divide")
    ndh = torch.full((1,), float(K1_NARROW[0]), device=dev)
    ndw = torch.full((1,), float(K1_NARROW[1]), device=dev)
    whole, _, _ = kernels.resample(xs, sh, sw, ndh, ndw, nhb, nwb, "lanczos3")
    nwin = [kernels.resample_window("lanczos3", CONFIG3_SRC[1], float(K1_NARROW[1]), swb,
                                    nwb, j * nlw, (j + 1) * nlw) for j in range(n)]
    nparts = [xs[:, :, k0:k1].contiguous() for k0, k1 in nwin]

    def narrow_k1(fn):
        return [fn(nparts[j], sh, sw, ndh, ndw, nhb, nwb, "lanczos3",
                   cols=(j * nlw, (j + 1) * nlw), in_col0=nwin[j][0], in_wb=swb)[0]
                for j in range(n)]

    got = narrow_k1(kernels.resample)
    case = f"4K-to-{K1_NARROW[1]}-u8-{n}shards"
    check_all("resample", list(zip(got, narrow_k1(reference.resample))), res, case, F32_TOL)
    if not all(torch.equal(g, whole[:, :, j * nlw:(j + 1) * nlw]) for j, g in enumerate(got)):
        raise AssertionError(f"K1's shard form [{case}] differs from the whole launch")
    log(f"  K1 shard form: {n} shards of {nlw} columns ({nlw % 32} past a whole tile), "
        f"input windows {nwin}, each bit-equal to the whole launch's columns")
    log("  blur and composite: no single-call library equivalent (per-image "
        "masked taps; per-image tiling and blend): library_ms null")


MARK_DIMS = (96, 240)  # phase 12's watermark image
MARK_AT = (40, 1500)  # its (top, left) on the 1080p frame; left clamps to 1680
MARK_OPACITY = 0.6


def composite_placed_case(res: dict, gen) -> None:
    """K7's placed form (replicate=0) at B=1 on K2's [1, 1152, 2048, 3]
    f32 output of large.jpg under a [1, 96, 240, 4] mark, as phase
    12(b)'s /watermarkimage launches it, with its time: the frame read
    and written once and the mark read once bound it; 12 flops a blended
    pixel."""
    import torch

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.kernels import reference
    from imaginary_tpu_torch.ops.buckets import bucket_dim, bucket_shape

    dev = torch.device(DEVICE)
    hb, wb = bucket_shape(1080, 1920)
    bh, bw = MARK_DIMS
    x = torch.rand((1, hb, wb, 3), generator=gen, device=dev) * 255.0
    ovl = torch.rand((1, bucket_dim(bh), bucket_dim(bw), 4), generator=gen, device=dev) * 255.0
    i32 = {"dtype": torch.int32, "device": dev}
    args = (x, ovl, torch.tensor([MARK_AT[0]], **i32), torch.tensor([1920 - bw], **i32),
            torch.tensor([MARK_OPACITY], device=dev), torch.tensor([bh], **i32),
            torch.tensor([bw], **i32), False)
    case = "B1-placed-1080p"
    got = kernels.composite(*args)
    check("composite", got, reference.composite(*args), res, case, F32_TOL)
    timing(res, "composite", case, lambda: kernels.composite(*args),
           lambda: reference.composite(*args), None,
           x.numel() * 4 + ovl.numel() * 4 + got.numel() * 4, 12.0 * bh * bw)


def offset_view(shape, dtype, offset: int, fill):
    """A contiguous tensor of `shape` whose data starts `offset` elements
    past a 16-byte boundary (a view into a larger buffer), filled by
    fill(n) -> a flat tensor of n elements."""
    import math

    import torch

    n = math.prod(shape)
    flat = torch.empty((n + offset,), dtype=dtype, device=DEVICE)
    flat[offset:] = fill(n)
    out = flat[offset:].view(shape)
    align = out.data_ptr() % 16
    if (align == 0) != (offset == 0):
        raise AssertionError(f"view at offset {offset} is {align} bytes off 16")
    return out


def pack_gray_phase(res: dict) -> None:
    """K3 and K8 at the seams of their designs, and K3's fused luma form,
    against their plain versions: K3 (U8_TOL) on PACK_SEAM_CASES (odd
    valid dims, valid edges on and past a 128-column chunk, 1x1 and empty
    images, a one-chunk tall bucket, wb % 4 == 2, an unaligned input); K8
    (F32_TOL, or U8_TOL on uint8 output) on GRAY_CASES (each dtype pair at
    C = 3 and 4, scalar tails, unaligned W-shard views); the fused form
    (`rgb_to_yuv420(..., luma=True)`, one launch) at the bw /resize's
    [1, 368, 640, 3] against `reference.gray` then
    `reference.rgb_to_yuv420`, bit for bit against the two kernels
    launched one after the other, and timed beside that pair."""
    import torch

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.kernels import reference

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def rand_f32(n):
        return torch.rand((n,), generator=gen, device=dev) * 295.0 - 20.0

    def rand_u8(n):
        return torch.randint(0, 256, (n,), generator=gen, device=dev, dtype=torch.uint8)

    for case, (hb, wb), hw, off in PACK_SEAM_CASES:
        x = offset_view((len(hw), hb, wb, 3), torch.float32, off, rand_f32)
        h, w = i32([a for a, _ in hw]), i32([b for _, b in hw])
        for luma in (False, True):
            check("yuv420_pack", kernels.rgb_to_yuv420(x, h, w, hb, wb, luma),
                  reference.rgb_to_yuv420(x, h, w, hb, wb, luma), res,
                  case + ("-luma" if luma else ""), U8_TOL)
    for case, shape, u8_in, u8_out, off in GRAY_CASES:
        x = offset_view(shape, torch.uint8 if u8_in else torch.float32, off,
                        rand_u8 if u8_in else rand_f32)
        check("gray", kernels.gray(x, u8_out), reference.gray(x, u8_out), res, case,
              U8_TOL if u8_out else F32_TOL)
    # the fused form on the bw /resize's frame
    hb, wb = BW_FRAME
    x = torch.rand((1, hb, wb, 3), generator=gen, device=dev) * 255.0
    h, w = i32([BW_VALID[0]]), i32([BW_VALID[1]])
    got = kernels.rgb_to_yuv420(x, h, w, hb, wb, luma=True)
    check("yuv420_pack", got,
          reference.rgb_to_yuv420(reference.gray(x), h, w, hb, wb), res, "bw-fused",
          U8_TOL)

    def pair():
        return kernels.rgb_to_yuv420(kernels.gray(x), h, w, hb, wb)

    if not torch.equal(got, pair()):
        raise AssertionError("K3's luma form differs from K8 then K3")
    timing(res, "yuv420_pack", "bw-fused",
           lambda: kernels.rgb_to_yuv420(x, h, w, hb, wb, luma=True),
           lambda: reference.rgb_to_yuv420(x, h, w, hb, wb, luma=True), None,
           x.numel() * 4 + got.numel(), 25.0 * x.numel() / 3)
    res["yuv420_pack"]["bw-fused"]["pair_ms"] = pair_ms = device_ms(pair)
    log(f"  K8 then K3 on the same frame, two launches: {pair_ms:.4f} ms; the fused "
        f"launch bit-equal to them")
    for name in ("yuv420_pack", "gray"):
        worst = max(res[name].items(), key=lambda kv: kv[1]["max_abs_err"])
        log(f"  {name} (redesigned): max |err| against the plain version over "
            f"{len(res[name])} cases {worst[1]['max_abs_err']!r} ({worst[0]})")


def out_param_phase(res: dict) -> None:
    """The chain-ending wrappers' `out=` (buffer donation, ops/chain.py):
    an `out` of the wrong shape, dtype or layout raises before any launch,
    and K3 and K7 writing into a donor region (offset 0 of a larger uint8
    buffer, as the chain's staged batch region is) match their plain
    versions (U8_TOL) and their own undonated output bit for bit."""
    import torch

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.kernels import reference

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)

    def i32(v, b):
        return torch.full((b,), v, dtype=torch.int32, device=dev)

    bsz, hb, wb = 16, 208, 304
    x = torch.rand((bsz, hb, wb, 3), generator=gen, device=dev) * 255.0
    h, w = i32(200, bsz), i32(300, bsz)
    shape = (bsz, hb + hb // 2, wb, 1)
    for bad, err in ((torch.empty((bsz, hb, wb, 1), dtype=torch.uint8, device=dev), ValueError),
                     (torch.empty(shape, dtype=torch.float32, device=dev), TypeError),
                     (torch.empty((bsz, hb + hb // 2, 2 * wb, 1), dtype=torch.uint8,
                                  device=dev)[:, :, :wb], ValueError)):
        try:
            kernels.rgb_to_yuv420(x, h, w, hb, wb, out=bad)
        except err:
            continue
        raise AssertionError(f"K3 took an out= of {tuple(bad.shape)} {bad.dtype} "
                             f"contiguous={bad.is_contiguous()}")
    # the donor: config 1's staged batch region at B=16 (its 320x512 packed
    # input), holding the 208x304 packed output at offset 0
    donor = torch.empty(bsz * 480 * 512, dtype=torch.uint8, device=dev)
    n = bsz * (hb + hb // 2) * wb
    got = kernels.rgb_to_yuv420(x, h, w, hb, wb, out=donor[:n].view(shape))
    if got.data_ptr() != donor.data_ptr():
        raise AssertionError("K3 did not write into its out=")
    check("yuv420_pack", got, reference.rgb_to_yuv420(x, h, w, hb, wb), res, "donated-B16",
          U8_TOL)
    if not torch.equal(got, kernels.rgb_to_yuv420(x, h, w, hb, wb)):
        raise AssertionError("K3 into a donated region differs from K3 undonated")
    # K7 on config 3's frame at B=8 into the 4K input's region
    bsz, hb, wb = 8, CONFIG3_FRAME[0], CONFIG3_FRAME[1]
    x = torch.rand((bsz, hb, wb, 3), generator=gen, device=dev) * 255.0
    overlay = torch.rand((bsz, 24, 48, 4), generator=gen, device=dev) * 255.0
    args = (overlay, i32(4, bsz), i32(8, bsz), torch.full((bsz,), 0.5, device=dev),
            i32(20, bsz), i32(40, bsz), True)
    try:
        kernels.composite(x, *args, out_u8=True,
                          out=torch.empty((bsz, hb, wb, 3), dtype=torch.float32,
                                          device=dev))
    except TypeError:
        pass
    else:
        raise AssertionError("K7 took an f32 out= for a uint8 epilogue")
    donor = torch.empty(bsz * CONFIG3_SRC_BUCKET[0] * CONFIG3_SRC_BUCKET[1] * 3,
                        dtype=torch.uint8, device=dev)
    n = bsz * hb * wb * 3
    got = kernels.composite(x, *args, out_u8=True, out=donor[:n].view(bsz, hb, wb, 3))
    if got.data_ptr() != donor.data_ptr():
        raise AssertionError("K7 did not write into its out=")
    check("composite", got, reference.composite(x, *args, True), res, "donated-B8",
          U8_TOL)
    if not torch.equal(got, kernels.composite(x, *args, out_u8=True)):
        raise AssertionError("K7 into a donated region differs from K7 undonated")
    log("  out=: wrong shape, dtype and layout refused; K3 (config 1 B=16) and K7 "
        "(config 3 B=8) into a donor region equal to their plain versions within "
        f"{U8_TOL} LSB and to themselves undonated bit for bit")


# K6 at the seams of its design (a block walks a run of rows of one strip
# of columns): (case, C, uint8 in and out)
BLUR_SEAM_CASES = (("strip-edges", 1, False), ("strip-edges", 2, False),
                   ("strip-edges", 3, False), ("strip-edges", 4, True),
                   ("under-r", 3, False), ("sigma0-beside", 3, False))
# K2 at the seams of its row design: (case, bucket, valid (h, w) per image)
YUV_SEAM_CASES = (
    ("odd-hw", (32, 48), ((31, 45), (27, 41))),
    ("1x1", (16, 16), ((1, 1), (16, 16))),
    ("full-bucket", (32, 48), ((32, 48), (32, 48))),  # chroma clamped at its edge
    ("wb-mod4-2", (18, 54), ((18, 54), (17, 53), (1, 3))),
    ("wb-mod4-2-wide", (64, 1922), ((64, 1922), (63, 1921))),
)

# K3 at the seams of its design (a block takes row pairs of one image over
# a chunk of 128 columns, four columns a lane; a bucket with wb % 4 == 2
# takes its scalar path): (case, bucket, valid (h, w) per image, offset
# of the input in floats past a 16-byte boundary)
PACK_SEAM_CASES = (
    ("odd-hw", (32, 48), ((31, 45), (27, 41)), 0),
    ("chunk-edges", (64, 384), ((63, 128), (64, 129), (2, 383)), 0),
    ("1x1-and-empty", (16, 16), ((1, 1), (0, 0)), 0),
    ("one-chunk-tall", (1088, 16), ((1081, 15),), 0),
    ("wb-mod4-2", (18, 258), ((17, 257), (18, 258)), 0),
    ("unaligned-input", (32, 48), ((31, 45),), 1),
)
# K8's vector groups and its scalar tail and unaligned form: (case,
# shape, uint8 in, uint8 out, offset of the input in elements past a
# 16-byte boundary). "shard" cases take a spatial W-shard's width
# (640 / 4 columns) from a buffer at an offset no vector load can start at.
GRAY_CASES = (
    ("C3-f32-tail", (1, 7, 9, 3), False, False, 0),
    ("C4-f32", (1, 368, 640, 4), False, False, 0),
    ("C3-u8-in", (1, 368, 640, 3), True, False, 0),
    ("C3-u8-out", (1, 368, 640, 3), False, True, 0),
    ("C4-u8-tail", (2, 37, 53, 4), True, True, 0),
    ("shard-unaligned-C3", (1, 368, 160, 3), False, False, 1),
    ("shard-unaligned-C4-u8", (1, 368, 160, 4), True, True, 3),
)


# K11 and K12 at the seams of their tiles (a K11 block makes 16 output
# rows by 128 columns of one image, a K12 block a band of 16 rows by 128
# columns): odd valid dims inside a larger bucket (4:2:0's and 4:2:2's
# chroma columns then clamp inside the bucket, not at its edge), B=3
# batches whose images differ, buckets 8 rows short of a tile and only
# one tile wide, a valid width ending inside a later column tile, every
# layout at k = 8, the three-plane layouts at k = 1, 2 and 4, and K12 at
# the /resize?width=1600 output bucket.
# (kernel, case, layout, k, bucket, valid (h, w) per image)
DCT_SEAM_CASES = (
    ("from_dct", "odd-hw-420", "420", 8, (48, 80), ((45, 77), (33, 51))),
    ("from_dct", "odd-hw-422", "422", 8, (40, 80), ((37, 75), (40, 79))),
    ("from_dct", "odd-hw-444", "444", 8, (40, 72), ((39, 71), (40, 72))),
    ("from_dct", "odd-hw-gray", "gray", 8, (24, 40), ((23, 37), (24, 40))),
    ("from_dct", "B3-420", "420", 8, (64, 272), ((64, 272), (61, 257), (17, 129))),
    ("from_dct", "B3-422", "422", 8, (24, 272), ((24, 272), (23, 257), (9, 129))),
    ("from_dct", "odd-w-mid-tile-420", "420", 8, (32, 400), ((31, 385), (32, 399))),
) + tuple(("from_dct", f"{lay}-k{k}", lay, k, (40, 144), ((37, 139), (40, 144), (19, 65)))
          for lay in ("420", "422", "444") for k in (1, 2, 4)) + (
    ("to_dct", "odd-hw", None, None, (48, 80), ((45, 77), (33, 51))),
    ("to_dct", "B3", None, None, (64, 272), ((64, 272), (61, 257), (17, 129))),
    ("to_dct", "one-mcu", None, None, (16, 16), ((1, 1), (16, 16))),
    ("to_dct", "resize-1600-bucket", None, None, (928, 1600), ((900, 1600),)),
)


# K11's and K12's W-shard forms at the seams of their designs, as (kernel,
# case, layout, k, bucket, valid (h, w) per image, shards): every layout
# at k = 8 and the three-plane layouts at k = 1, 2 and 4 (all with odd
# valid dims, and shards of 64 or 48 columns: a partial 128-column tile);
# the valid chroma edge inside a shard's right halo block and, for the
# next shard, past its left edge (hi 65 at lw 64); shards wholly past the
# valid width whose clamp block (hi 49, block 6) lies outside their
# natural window; a batch whose images clamp differently; shards of 1.5
# tiles. K12: MCUs straddling two shards (lw 52, and 100: its Y blocks
# straddle too), shards past the valid width, odd valid h, one MCU, B=3.
DCT_SHARD_SEAM_CASES = (
    ("from_dct", "420-k8-odd-w", "420", 8, (48, 256), ((45, 201),), 4),
    ("from_dct", "422-k8-odd-w", "422", 8, (40, 256), ((37, 233),), 4),
    ("from_dct", "444-k8-odd-w", "444", 8, (40, 256), ((39, 251),), 4),
    ("from_dct", "gray-k8-odd-w", "gray", 8, (24, 192), ((23, 185),), 4),
) + tuple(("from_dct", f"{lay}-k{k}", lay, k, (40, 192), ((37, 187),), 4)
          for lay in ("420", "422", "444") for k in (1, 2, 4)) + (
    ("from_dct", "420-edge-in-halo", "420", 8, (32, 256), ((31, 131),), 4),
    ("from_dct", "422-edge-in-halo", "422", 8, (32, 256), ((31, 131),), 4),
    ("from_dct", "420-past-valid", "420", 8, (32, 512), ((29, 99),), 4),
    ("from_dct", "422-past-valid", "422", 8, (16, 512), ((16, 100),), 4),
    ("from_dct", "420-B3", "420", 8, (64, 256), ((64, 256), (61, 201), (17, 99)), 4),
    ("from_dct", "420-tile-and-a-half", "420", 8, (32, 768), ((32, 701),), 4),
    ("to_dct", "odd-hw", None, None, (48, 96), ((45, 77),), 2),
    ("to_dct", "straddle", None, None, (32, 208), ((31, 201),), 4),
    ("to_dct", "straddle-y-blocks", None, None, (48, 400), ((45, 211),), 4),
    ("to_dct", "past-valid", None, None, (32, 256), ((29, 97),), 4),
    ("to_dct", "odd-h", None, None, (48, 160), ((33, 160),), 2),
    ("to_dct", "one-mcu", None, None, (16, 32), ((1, 1),), 2),
    ("to_dct", "B3", None, None, (64, 272), ((64, 272), (61, 257), (17, 129)), 4),
)


def dct_shard_inputs(case: tuple, rng, dev) -> tuple:
    """A DCT_SHARD_SEAM_CASES case's seeded inputs on dev: the whole
    kernel's arguments and each shard's (col0, arguments of
    `from_dct_shard` / `to_dct_shard`), made as the spatial route makes
    them (`FromDctSpec.shard_input` for each image; K12's window the
    union of the images' `ToDctSpec.shard_window`s)."""
    import numpy as np
    import torch

    from imaginary_tpu_torch.codecs import jpeg_dct
    from imaginary_tpu_torch.ops.stages import FromDctSpec, ToDctSpec

    kernel, _, layout, k, (hb, wb), hw, n = case
    bsz, lw = len(hw), wb // n
    x_np = dct_seam_inputs(kernel, layout, k, (hb, wb), bsz, rng)
    x = torch.from_numpy(x_np).to(dev)
    h = torch.tensor([a for a, _ in hw], dtype=torch.int32, device=dev)
    w = torch.tensor([b for _, b in hw], dtype=torch.int32, device=dev)
    shards = []
    if kernel == "from_dct":
        spec = FromDctSpec(hb, wb, k, layout)
        for j in range(n):
            c0 = j * lw
            parts = [spec.shard_input(x_np[i], c0, c0 + lw, b, {})[:3]
                     for i, (_, b) in enumerate(hw)]
            xs, left, right = (None if p[0] is None else
                               torch.from_numpy(np.ascontiguousarray(np.stack(p))).to(dev)
                               for p in zip(*parts))
            shards.append((c0, (xs, left, right, h, w, hb, lw, k, layout, c0, wb)))
        return (x, h, w, hb, wb, k, layout), shards
    qy, qc = jpeg_dct.quality_tables(80)
    q_y = torch.tensor(np.stack([qy] * bsz), dtype=torch.float32, device=dev)
    q_c = torch.tensor(np.stack([qc] * bsz), dtype=torch.float32, device=dev)
    spec = ToDctSpec(hb, wb)
    for j in range(n):
        c0 = j * lw
        wins = [spec.shard_window(c0, c0 + lw, b, wb, {}) for _, b in hw]
        k0, k1 = min(a for a, _ in wins), max(b for _, b in wins)
        shards.append((c0, (x[:, :, k0:k1].contiguous(), h, w, q_y, q_c, hb, lw, c0, k0,
                            wb)))
    return (x, h, w, q_y, q_c, hb, wb), shards


def dct_shard_seams(res: dict) -> None:
    """K11's and K12's W-shard entries on DCT_SHARD_SEAM_CASES: every
    shard's output bit-equal to the whole image's kernel at its columns
    (K11 padding included; K12's shards put together by
    `ToYuv420Spec.shard_assemble`), and within F32_TOL (K11) or
    `check_coef` (K12) of its plain version; case names start with
    "shard-seam-"."""
    import numpy as np
    import torch

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.kernels import reference
    from imaginary_tpu_torch.ops.stages import ToYuv420Spec

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 24)
    for case in DCT_SHARD_SEAM_CASES:
        kernel, name, _, _, (hb, wb), _, n = case
        whole_args, shards = dct_shard_inputs(case, rng, dev)
        lw = wb // n
        if kernel == "from_dct":
            whole = kernels.from_dct(*whole_args)
            for j, (c0, args) in enumerate(shards):
                got = kernels.from_dct_shard(*args)
                if not torch.equal(got, whole[:, :, c0:c0 + lw]):
                    raise AssertionError(f"K11 shard {j} of {name}: not K11's columns")
                check("from_dct", got, reference.from_dct_shard(*args), res,
                      f"shard-seam-{name}-{j}", F32_TOL)
        else:
            whole = kernels.to_dct(*whole_args)
            parts = []
            for j, (c0, args) in enumerate(shards):
                got = kernels.to_dct_shard(*args)
                check_coef("to_dct", got, reference.to_dct_shard(*args), res,
                           f"shard-seam-{name}-{j}")
                parts.append(got)
            assembled = ToYuv420Spec(hb, wb).shard_assemble(torch.stack(parts).cpu())
            if not np.array_equal(assembled, whole.cpu().numpy()):
                raise AssertionError(f"K12 shards of {name}: not K12's coefficients")
    for name in DCT_KERNELS:
        seams = {c: v for c, v in res[name].items() if c.startswith("shard-seam-")}
        worst = max(seams.items(), key=lambda kv: kv[1]["max_abs_err"])
        log(f"  {name}'s W-shard entry: bit-equal to the whole kernel's columns over "
            f"{len(seams)} shards of {sum(c[0] == name for c in DCT_SHARD_SEAM_CASES)} "
            f"seam cases; max |err| against the plain version {worst[1]['max_abs_err']!r} "
            f"({worst[0][len('shard-seam-'):]})")


def dct_seam_inputs(kernel: str, layout, k, bucket: tuple, bsz: int, rng):
    """Seeded numpy input of a DCT_SEAM_CASES case. K11: int16
    coefficients in FromDctSpec's packed layout, each block's term (u, v)
    uniform in +-600 / (1 + u + v), so the samples span and overshoot
    0-255. K12: f32 RGB uniform in [-20, 275] (the clip is part of it)."""
    import numpy as np

    from imaginary_tpu_torch import kernels

    hb, wb = bucket
    if kernel == "to_dct":
        return rng.uniform(-20.0, 275.0, (bsz, hb, wb, 3)).astype(np.float32)
    rows, cols, c = kernels.dct_in_shape(layout, k, hb, wb)
    x = np.zeros((bsz, rows, cols, c), np.int16)
    for r0, nr, c0, nc, ch, kv, kh in kernels.dct_regions(layout, k, hb, wb):
        amp = 600.0 / (1 + (np.arange(nr) % kv)[:, None] + (np.arange(nc) % kh)[None, :])
        x[:, r0:r0 + nr, c0:c0 + nc, ch] = np.rint(rng.uniform(-1.0, 1.0, (bsz, nr, nc)) * amp)
    return x


def check_coef(name, got, want, results, case):
    """K12's int16 coefficients: within COEF_TOL, at most COEF_SHARE of
    them differing (rounding ties)."""
    d = (got.int() - want.int()).abs()
    share = float((d > 0).float().mean())
    err = int(d.max())
    if err > COEF_TOL or share > COEF_SHARE:
        raise AssertionError(f"{name} [{case}]: max {err}, {share:.2e} of the "
                             f"coefficients differ (bounds {COEF_TOL}, {COEF_SHARE})")
    results.setdefault(name, {})[case] = {"max_abs_err": float(err), "differing_share": share}
    return err


def dct_seams(res: dict) -> None:
    """K11 (within F32_TOL) and K12 (check_coef) on DCT_SEAM_CASES against
    their plain versions; case names start with "seam-"."""
    import numpy as np
    import torch

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.codecs import jpeg_dct
    from imaginary_tpu_torch.kernels import reference

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 8)
    qy, qc = jpeg_dct.quality_tables(80)
    for kernel, case, layout, k, (hb, wb), hw in DCT_SEAM_CASES:
        bsz = len(hw)
        x = torch.from_numpy(dct_seam_inputs(kernel, layout, k, (hb, wb), bsz, rng)).to(dev)
        h = torch.tensor([a for a, _ in hw], dtype=torch.int32, device=dev)
        w = torch.tensor([b for _, b in hw], dtype=torch.int32, device=dev)
        if kernel == "from_dct":
            args = (x, h, w, hb, wb, k, layout)
            check("from_dct", kernels.from_dct(*args), reference.from_dct(*args), res,
                  "seam-" + case, F32_TOL)
        else:
            q_y = torch.tensor(np.stack([qy] * bsz), dtype=torch.float32, device=dev)
            q_c = torch.tensor(np.stack([qc] * bsz), dtype=torch.float32, device=dev)
            args = (x, h, w, q_y, q_c, hb, wb)
            check_coef("to_dct", kernels.to_dct(*args), reference.to_dct(*args), res,
                       "seam-" + case)
    for name in DCT_KERNELS:
        seams = {c: v for c, v in res[name].items() if c.startswith("seam-")}
        worst = max(seams.items(), key=lambda kv: kv[1]["max_abs_err"])
        log(f"  {name} (redesigned): max |err| against the plain version over "
            f"{len(seams)} seam cases {worst[1]['max_abs_err']!r} ({worst[0][5:]})")


def blur_seam_inputs(case: str, c: int) -> tuple:
    """(shape, h, w, sigma, radius) of a K6 seam case: "strip-edges" has
    valid widths one column inside and one past a strip of
    `kernels.blur_strip(c, 4)` columns and heights one row inside and past
    a group of `kernels.BLUR_ROW_GROUP` rows; "under-r" images narrower
    and shorter than r = 64; "sigma0-beside" the delta beside Gaussians."""
    from imaginary_tpu_torch import kernels

    if case == "strip-edges":
        strip, rows = kernels.blur_strip(c, 4), kernels.BLUR_ROW_GROUP
        return ((4, 10 * rows, 2 * strip + 6, c), (2 * rows - 1, 2 * rows + 1, 10 * rows, 1),
                (strip - 1, strip + 1, 2 * strip + 6, 2 * strip + 5), (1.2, 2.0, 0.7, 3.0), 4)
    if case == "under-r":
        return (3, 40, 56, c), (5, 40, 1), (3, 56, 2), (20.0, 3.0, 0.5), 64
    return (3, 40, 56, c), (40, 33, 17), (56, 41, 1), (0.0, 1.5, 0.0), 4


def seams_phase(res: dict) -> None:
    """K1, K4, K6, K2, K11, K12, K9 and K10 at the seams of their designs, against their
    plain versions (K1, K6 and K2 within F32_TOL, or U8_TOL on uint8
    output; K4 exact): K1 at output dims that are not multiples of its
    16 x 32 tile, on a batch whose images have different scales (one of
    them an upscale), at an extreme downscale (1080p to 8x8, whose input
    band spans many staged chunks), at a 4x upscale, uint8 in and out, and
    at C = 1 and 4; K4's window at odd and negative offsets (the unaligned
    and clamped ends of its row copy) in every dtype pair, and its clamp,
    mirror and fill modes with per-image offsets and sizes at B=32; K6's
    BLUR_SEAM_CASES; K2's
    YUV_SEAM_CASES (rows whose output or luma start is unaligned, ragged
    row ends); K11's and K12's DCT_SEAM_CASES (`dct_seams`); K9's and
    K10's SAL_SEAM_CASES (`sal_seams`); K11's and K12's W-shard entries on
    DCT_SHARD_SEAM_CASES (`dct_shard_seams`)."""
    import torch

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.kernels import reference

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    def frame(shape, u8=False):
        if u8:
            return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)
        return torch.rand(shape, generator=gen, device=dev) * 255.0

    # (case, x shape, uint8 in, valid h, w, dst h, w, out bucket, kind, uint8 out)
    k1_cases = (
        ("tile-edges", (2, 100, 150, 3), False, (100, 97), (150, 141), (37, 41),
         (53, 66), (41, 67), "lanczos3", False),
        ("mixed-scales", (4, 1088, 1920, 3), False, (1080, 1080, 700, 200),
         (1920, 1900, 1300, 300), (169.0, 540.0, 300.0, 530.0),
         (300.0, 960.0, 557.0, 795.0), (544, 960), "lanczos3", False),
        ("1080p-to-8x8", (1, 1088, 1920, 3), False, (1080,), (1920,), (8.0,), (8.0,),
         (16, 16), "lanczos3", False),
        ("upscale-4x", (2, 64, 96, 3), False, (64, 60), (96, 90), (256.0, 240.0),
         (384.0, 360.0), (256, 384), "lanczos3", False),
        ("u8-in-out", (8, 320, 512, 3), True, (300,) * 8, (512, 500, 480, 460) * 2,
         (200.0,) * 8, (300.0, 293.0, 281.0, 270.0) * 2, (208, 304), "lanczos3", True),
        ("C4-u8-cubic", (2, 96, 160, 4), True, (96, 90), (160, 150), (31.0, 60.0),
         (47.0, 99.0), (64, 112), "cubic", False),
        ("C1-nearest", (2, 96, 160, 1), False, (96, 95), (160, 159), (48.0, 190.0),
         (80.0, 318.0), (192, 320), "nearest", False),
    )
    for case, shape, u8, h, w, dh, dw, (ohb, owb), kind, out_u8 in k1_cases:
        x = frame(shape, u8)
        args = (x, i32(h), i32(w), f32(dh), f32(dw), ohb, owb, kind, out_u8)
        got, gh, gw = kernels.resample(*args)
        want, _, _ = reference.resample(*args)
        if not (torch.equal(gh.cpu(), torch.tensor(dh).to(torch.int32))
                and torch.equal(gw.cpu(), torch.tensor(dw).to(torch.int32))):
            raise AssertionError(f"resample [{case}]: output dims wrong")
        check("resample", got, want, res, case, U8_TOL if out_u8 else F32_TOL)
        del x, got, want
    # K4's window at odd and negative offsets, each dtype pair
    x = frame((4, 300, 517, 3))
    xu = frame((4, 300, 517, 3), True)
    top, left = i32((0, 5, -3, 290)), i32((1, 3, -7, 511))
    for name, src, out_u8 in (("f32", x, False), ("f32-u8", x, True),
                              ("u8", xu, True), ("u8-f32", xu, False)):
        args = (src, 208, 301, top, left)
        check("gather", kernels.gather(*args, mode="window", out_u8=out_u8),
              reference.gather(*args, mode="window", out_u8=out_u8), res,
              f"window-odd-{name}", 0.0)
    # clamp, mirror and fill with per-image offsets and sizes at B=32
    bsz = 32
    x = frame((bsz, 192, 320, 3))
    i = torch.arange(bsz, dtype=torch.int32, device=dev)
    off_y, off_x = (i % 7 - 2) * 5, (i % 5) * 9 - 3
    size_h, size_w = 169 - i, 300 - 3 * i
    fill = torch.rand((bsz, 3), generator=gen, device=dev) * 255.0
    for mode, f in (("clamp", None), ("mirror", None), ("clamp", fill), ("mirror", fill)):
        args = (x, 208, 304, off_y, off_x, size_h, size_w, mode)
        check("gather", kernels.gather(*args, fill=f), reference.gather(*args, fill=f),
              res, f"B32-{mode}{'-fill' if f is not None else ''}", 0.0)
    del x, xu
    for case, c, u8 in BLUR_SEAM_CASES:
        shape, h, w, sig, r = blur_seam_inputs(case, c)
        args = (frame(shape, u8), i32(h), i32(w), f32(sig), r, u8)
        check("blur", kernels.blur(*args), reference.blur(*args), res,
              f"{case}-C{c}" + ("-u8" if u8 else ""), U8_TOL if u8 else F32_TOL)
    for case, (hb, wb), hw in YUV_SEAM_CASES:
        x = frame((len(hw), hb + hb // 2, wb, 1), True)
        args = (x, i32([a for a, _ in hw]), i32([b for _, b in hw]), hb, wb)
        check("yuv420_unpack", kernels.yuv420_to_rgb(*args),
              reference.yuv420_to_rgb(*args), res, case, F32_TOL)
    for name in ("blur", "yuv420_unpack"):
        worst = max(res[name].items(), key=lambda kv: kv[1]["max_abs_err"])
        log(f"  {name} (redesigned): max |err| against the plain version over "
            f"{len(res[name])} cases {worst[1]['max_abs_err']!r} ({worst[0]})")
    dct_seams(res)
    dct_shard_seams(res)
    sal_seams(res)


def timing(res, name, case, kernel_fn, plain_fn, lib_fn, nbytes, flops):
    import torch

    ms = device_ms(kernel_fn)
    call = call_ms(kernel_fn)
    plain = device_ms(plain_fn, calls=3, reps=3)
    lib = device_ms(lib_fn) if lib_fn is not None else None
    b, by = bound_ms(int(nbytes), float(flops))
    res[name][case].update({"ms": ms, "call_ms": call, "plain_ms": plain,
                            "library_ms": lib, "bound_ms": b, "bound_by": by,
                            "bytes": int(nbytes), "flops": float(flops)})
    lib_s = f"{lib:.4f}" if lib is not None else "null"
    log(f"  {name:14s} {case:16s} err {res[name][case]['max_abs_err']:.3g}  "
        f"kernel {ms:.4f} ms (call {call:.4f})  plain {plain:.4f} ms  "
        f"library {lib_s} ms  bound {b:.4f} ms ({by})")
    torch.cuda.synchronize()


# --- phase 4: the main path through the server ------------------------------

def http(port: int, path: str, body):
    """(status, content type, body) of a POST of `body`, or of a GET when
    body is None."""
    headers = {}
    if body is not None:
        headers["Content-Type"] = "image/png" if body[:4] == b"\x89PNG" else "image/jpeg"
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.headers["Content-Type"], r.read()


def main_path_phase() -> dict:
    import torch

    from imaginary_tpu_torch import codecs, kernels
    from imaginary_tpu_torch.web.app import make_server

    with open(LARGE_JPG, "rb") as f:
        buf = f.read()
    srv = make_server("127.0.0.1", 0, device=DEVICE)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    lat: dict = {}
    answers: dict = {}
    try:
        # one untimed request per route first: the first CUDA use loads the
        # kernel libraries and the caching allocator's first blocks
        for op in ("resize", "crop"):
            http(port, f"/{op}?width=300&height=200", buf)
        kernels.reset_launches()
        for op in ("resize", "crop"):
            lat[op] = []
            for _ in range(3):
                t0 = time.perf_counter()
                status, ctype, body = http(port, f"/{op}?width=300&height=200", buf)
                lat[op].append((time.perf_counter() - t0) * 1e3)
                if status != 200 or ctype != "image/jpeg":
                    raise AssertionError(f"/{op}: {status} {ctype}")
                d = codecs.decode(body)
                if d.array.shape[:2] != (200, 300):
                    raise AssertionError(f"/{op}: output {d.array.shape}")
                answers[op] = body
        launches = kernels.launch_counts()
        prof = profile_requests(port, buf)
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)
    # one launch of each of K2, K1, K4 and K3 a request, nothing else
    want = {k: (6 if k in CONFIG1_KERNELS else 0) for k in launches}
    if launches != want:
        raise AssertionError(f"config 1's six requests launched {launches}, not {want}")
    for op, ts in lat.items():
        log(f"  /{op}: {', '.join(f'{t:.2f}' for t in ts)} ms")
    log(f"  launches: {launches}")
    log(f"  profiled {prof['requests']} requests: device busy {prof['device_busy_us']:.1f} us "
        f"of {prof['wall_us']:.1f} us wall (share {prof['busy_share']:.4f})")
    for name, us in sorted(prof["by_name_us"].items(), key=lambda kv: -kv[1]):
        log(f"    {us / prof['requests']:9.2f} us/request  {name[:90]}")
    torch.cuda.synchronize()
    # phase 14 holds its config 1 answers byte-equal to this server's
    PHASE4_ANSWERS.update(answers)
    return {"latency_ms": lat, "launches": launches, "profile": prof,
            "resize_sha256": hashlib.sha256(answers["resize"]).hexdigest()}


def profile_requests(port: int, buf: bytes, rounds: int = 3) -> dict:
    """Device busy time over a window of requests, from torch.profiler
    (CUPTI): every kernel and copy the card ran, summed by name."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            for op in ("resize", "crop"):
                http(port, f"/{op}?width=300&height=200", buf)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
    busy = sum(by_name.values())
    return {"requests": 2 * rounds, "wall_us": wall_us, "device_busy_us": busy,
            "busy_share": busy / wall_us, "by_name_us": dict(by_name)}


def main_plan(op: str, transport: str, query=None, src: str = LARGE_JPG):
    """(input array, plan) of the server's request for `op` on `src`
    (300x200 unless a query is given), planned as the pipeline plans it."""
    from imaginary_tpu_torch import codecs
    from imaginary_tpu_torch.ops import plan as plan_mod
    from imaginary_tpu_torch.ops.buckets import bucket_shape
    from imaginary_tpu_torch.params import build_params_from_query

    with open(src, "rb") as f:
        buf = f.read()
    o = build_params_from_query(query or {"width": "300", "height": "200"})
    meta = codecs.probe_fast(buf)
    shrink = plan_mod.choose_decode_shrink(op, o, meta.height, meta.width,
                                           meta.orientation, 3)
    sh, sw = -(-meta.height // shrink), -(-meta.width // shrink)
    p = plan_mod.plan_operation(op, o, sh, sw, meta.orientation, 3)
    if transport == "yuv420":
        hb, wb = bucket_shape(sh, sw)
        packed, _, _, _ = codecs.decode_yuv420(buf, shrink, hb, wb)
        return packed, plan_mod.wrap_plan_yuv420(p, sh, sw)
    return codecs.decode(buf, shrink).array, p


def planes_err(a, b) -> int:
    import numpy as np

    if hasattr(a, "y"):
        return max(int(np.abs(getattr(a, k).astype(int) - getattr(b, k).astype(int)).max())
                   for k in ("y", "u", "v"))
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def parity_phase(rng, png: bytes) -> dict:
    import numpy as np

    from imaginary_tpu_torch.ops import chain

    out = {}
    # the bw /resize: K8 folded into K3 on the yuv420 transport, K8 alone on rgb
    for op, query in (("resize", None), ("crop", None), ("thumbnail", None),
                      ("rotate", {"rotate": "90"}), ("resize", BW_QUERY)):
        for transport in ("yuv420", "rgb"):
            arr, p = main_plan(op, transport, query)
            err = planes_err(chain.run_single(arr, p, device=DEVICE),
                             chain.run_single(arr, p, device="cpu"))
            if err > U8_TOL:
                raise AssertionError(f"{op}/{transport}: cuda vs cpu {err} LSB")
            out[f"{op}{'-bw' if query == BW_QUERY else ''}-{transport}"] = err
    log(f"  run_single cuda vs cpu, max LSB: {out}")
    # phase 5: B=16 on config 1's plan, and config 2's chains at the
    # batch its server forms (B=32), each image with its own noise
    batches = [("resize", None, LARGE_JPG, 16)] + [
        (op, query, src, CONFIG2_BATCH) for op, query, src in CONFIG2_PLANS]
    for op, query, src, bsz in batches:
        arr, p = main_plan(op, "yuv420", query, src)
        arrs = [arr] + [np.clip(arr.astype(np.int32) + rng.integers(-12, 13, size=arr.shape),
                                0, 255).astype(np.uint8) for _ in range(bsz - 1)]
        plans = [p] * bsz
        got = chain.run_batch(arrs, plans, device=DEVICE)
        want = chain.run_batch(arrs, plans, device="cpu")
        err = max(planes_err(a, b) for a, b in zip(got, want))
        if err > U8_TOL:
            raise AssertionError(f"run_batch {op} B={bsz}: cuda vs cpu {err} LSB")
        name = f"run_batch-{op}{'-exif6' if src == EXIF6_JPG else ''}-B{bsz}"
        out[name] = err
        log(f"  {name} cuda vs cpu, max LSB: {err}")
        del arrs, got, want
    # config 3's /pipeline chain on the 4K PNG (rgb transport, uint8 4K in)
    # and the 1080p JPEG /pipeline chain (yuv420 transport)
    with open(LARGE_JPG, "rb") as f:
        jpg = f.read()
    for name, buf, ops, transport in (("config3", png, CONFIG3_OPS, "rgb"),
                                      ("jpeg-pipeline", jpg, JPEG_PIPELINE_OPS, "yuv420")):
        arr, p = pipeline_request(buf, ops, transport)
        for bsz in CONFIG3_BATCHES:
            arrs = [arr] + [np.clip(arr.astype(np.int16) + rng.integers(-12, 13, size=arr.shape,
                                                                       dtype=np.int16),
                                    0, 255).astype(np.uint8) for _ in range(bsz - 1)]
            got = chain.run_batch(arrs, [p] * bsz, device=DEVICE)
            want = chain.run_batch(arrs, [p] * bsz, device="cpu")
            err = max(planes_err(a, b) for a, b in zip(got, want))
            if err > U8_TOL:
                raise AssertionError(f"run_batch {name} B={bsz}: cuda vs cpu {err} LSB")
            out[f"run_batch-{name}-B{bsz}"] = err
            log(f"  run_batch-{name}-B{bsz} cuda vs cpu, max LSB: {err}")
            del arrs, got, want
    return out


def pipeline_request(buf: bytes, ops: list, transport: str):
    """(input array, plan) of the /pipeline request for `ops` on buf,
    planned as `pipeline.process_pipeline` plans it: the packed 4:2:0
    input and the wrapped plan for "yuv420", the decoded frame for "rgb"."""
    from imaginary_tpu_torch import codecs, pipeline
    from imaginary_tpu_torch.imgtype import ImageType
    from imaginary_tpu_torch.ops.plan import wrap_plan_yuv420
    from imaginary_tpu_torch.params import build_params_from_operation, build_params_from_query

    o = build_params_from_query({"operations": json.dumps(ops)})
    if transport == "yuv420":
        meta = codecs.probe_fast(buf)
        first = o.operations[0]
        shrink = pipeline._pick_shrink(first.name, ImageType.JPEG,
                                       build_params_from_operation(first), meta)
        sh, sw = -(-meta.height // shrink), -(-meta.width // shrink)
        packed, _, _ = pipeline._decode_yuv_packed(buf, shrink, sh, sw)
        plan = pipeline._build_pipeline_plan(o, sh, sw, meta.orientation, 3, ImageType.JPEG)[0]
        return packed, wrap_plan_yuv420(plan, sh, sw)
    d = codecs.decode(buf)
    plan = pipeline._build_pipeline_plan(o, d.array.shape[0], d.array.shape[1], d.orientation,
                                         d.array.shape[2], d.type)[0]
    return d.array, plan


# --- phase 6: config 2's mixed traffic under load ---------------------------

# config 2's chains as (op, query, source): the three routes on the 1080p
# JPEG, and /resize of a JPEG stored with EXIF orientation 6
CONFIG2_PLANS = (
    ("thumbnail", None, LARGE_JPG),
    ("crop", None, LARGE_JPG),
    ("rotate", {"rotate": "90"}, LARGE_JPG),
    ("resize", {"width": "120", "height": "90"}, EXIF6_JPG),
)

# (path, source, decoded output (h, w)); exif-orient-6.jpg is 400x300
# stored with EXIF orientation 6, so its /resize transposes and flops first
CONFIG2_REQUESTS = (
    ("/thumbnail?width=300&height=200", LARGE_JPG, (200, 300)),
    ("/crop?width=300&height=200", LARGE_JPG, (200, 300)),
    ("/rotate?rotate=90", LARGE_JPG, (1920, 1080)),
    ("/resize?width=120&height=90", EXIF6_JPG, (90, 120)),
)
CLIENTS = 32
PER_CLIENT = 8
# timed load windows of CLIENTS * PER_CLIENT requests each: one window
# lasts about a second on the card's host, so one alone says little
WINDOWS = 2
CONFIG2_MAX_BATCH = 32
CONFIG2_FORM_MS = 5.0


def load_window(port: int, reqs: list, clients: int = CLIENTS,
                per_client: int = PER_CLIENT) -> tuple:
    """`clients` threads, `per_client` requests each, cycling through reqs
    ((path, body) pairs), all started together. Returns (wall seconds,
    [(request index, latency ms, status, content type, body)])."""
    n_req = clients * per_client
    results: list = [None] * n_req
    errors: list = []
    start = threading.Barrier(clients + 1)

    def client(t: int) -> None:
        start.wait()
        try:
            for i in range(per_client):
                n = t * per_client + i
                k = n % len(reqs)
                path, body = reqs[k]
                t0 = time.perf_counter()
                status, ctype, out = http(port, path, body)
                results[n] = (k, (time.perf_counter() - t0) * 1e3, status, ctype, out)
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(clients)]
    for th in threads:
        th.start()
    start.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return wall, results


def busy_union_us(prof) -> tuple:
    """(busy us, summed us, by-name us) of the card's activity in a
    torch.profiler window. The busy time is the union of the kernels' and
    copies' intervals, so work that overlaps (a copy engine beside the
    compute units, or another stream) counts once."""
    import collections

    from torch.autograd import DeviceType

    spans, by_name = [], collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] += e.time_range.elapsed_us()
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy, sum(by_name.values()), dict(by_name)


def decoded_planes(codecs, body: bytes, dims: tuple):
    from imaginary_tpu_torch.ops.buckets import bucket_shape

    packed, h, w, _ = codecs.decode_yuv420(body, 1, *bucket_shape(*dims))
    if (h, w) != dims:
        raise AssertionError(f"decoded {h}x{w}, expected {dims}")
    return packed


def config2_phase() -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from imaginary_tpu_torch import codecs, kernels
    from imaginary_tpu_torch.web.app import make_server

    bodies = {}
    for _, src, _ in CONFIG2_REQUESTS:
        with open(src, "rb") as f:
            bodies[src] = f.read()
    srv = make_server("127.0.0.1", 0, device=DEVICE, max_batch=CONFIG2_MAX_BATCH,
                      batch_form_ms=CONFIG2_FORM_MS)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    ex = srv.service.executor
    try:
        # one untimed request per route, then each served alone: the
        # planes every batched answer is held against
        for path, src, _ in CONFIG2_REQUESTS:
            http(port, path, bodies[src])
        alone = []
        kernels.reset_launches()
        for path, src, dims in CONFIG2_REQUESTS:
            status, ctype, body = http(port, path, bodies[src])
            if (status, ctype) != (200, "image/jpeg"):
                raise AssertionError(f"{path} alone: {status} {ctype}")
            alone.append((body, decoded_planes(codecs, body, dims)))
        alone_launches = kernels.launch_counts()
        PHASE6_ANSWERS[:] = [body for body, _ in alone]  # phase 16(g)'s reference
        items0, batches0 = ex.stats.items, ex.stats.batches
        reqs = [(path, bodies[src]) for path, src, _ in CONFIG2_REQUESTS]
        kernels.reset_launches()
        walls, results = [], []
        for _ in range(WINDOWS):
            wall, got = load_window(port, reqs)
            walls.append(wall)
            results.extend(got)
        launches = kernels.launch_counts()
        items, batches = ex.stats.items - items0, ex.stats.batches - batches0
        max_group = ex.stats.max_group_seen
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            wall2, _ = load_window(port, reqs)
            prof_wall_us = (time.perf_counter() - t0) * 1e6
        executor = ex.stats.to_dict()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)
    for name in CONFIG2_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on config 2's path")
    # each route served alone launches its plan's kernels: one K5 for the
    # /rotate's transpose and flop, one for the EXIF-6 /resize's (the fold)
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    for path, src, _ in CONFIG2_REQUESTS:
        op, _, q = path[1:].partition("?")
        arr, p = request_plan(bodies[src], op, dict(urllib.parse.parse_qsl(q)))
        for k, v in expected_launches(p, arr).items():
            want[k] += v
    if alone_launches != want or want["orient"] != ROTATE_ORIENT + EXIF6_ORIENT:
        raise AssertionError(f"config 2's routes alone launched {alone_launches}, the plans "
                             f"say {want}")
    log(f"  each route alone: launches {alone_launches} (K5 {want['orient']}: one a /rotate "
        f"and one an EXIF-6 /resize)")
    if max_group < 2:
        raise AssertionError(f"no batch formed under load (largest group {max_group})")
    identical, worst = 0, 0
    lat = [r[1] for r in results]
    by_kind: dict = {}
    for k, ms, status, ctype, body in results:
        path, _, dims = CONFIG2_REQUESTS[k]
        if (status, ctype) != (200, "image/jpeg"):
            raise AssertionError(f"{path}: {status} {ctype}")
        if body == alone[k][0]:
            identical += 1
        else:
            planes = decoded_planes(codecs, body, dims)
            err = int(np.abs(planes.astype(np.int32) - alone[k][1].astype(np.int32)).max())
            if err > U8_TOL:
                raise AssertionError(f"{path}: batched planes {err} LSB from alone")
            worst = max(worst, err)
        if codecs.decode(body).array.shape[:2] != dims:
            raise AssertionError(f"{path}: output is not {dims}")
        by_kind.setdefault(path, []).append(ms)
    busy, summed, by_name = busy_union_us(prof)
    n = len(results)
    rps = [CLIENTS * PER_CLIENT / w for w in walls]
    out = {
        "mix": "equal weights, chosen: " + ", ".join(p for p, _, _ in CONFIG2_REQUESTS),
        "requests": n, "windows": WINDOWS, "wall_s": walls, "rps_by_window": rps,
        "rps": statistics.median(rps),
        "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
        "p50_ms_by_route": {p: float(np.percentile(v, 50)) for p, v in by_kind.items()},
        "items": items, "batches": batches, "mean_batch": items / batches,
        "max_group_seen": max_group, "launches": launches, "launches_alone": alone_launches,
        "identical_bodies": identical, "max_lsb_vs_alone": worst,
        "profiled": {"wall_s": wall2, "rps": CLIENTS * PER_CLIENT / wall2,
                     "wall_us": prof_wall_us,
                     "device_busy_us": busy, "device_summed_us": summed,
                     "busy_share": busy / prof_wall_us, "by_name_us": by_name},
        "executor": executor,
    }
    log(f"  the smoke's mix ({out['mix']}): {n} requests from {CLIENTS} clients in "
        f"{WINDOWS} windows of {sum(walls):.3f} s in all; req/s by window "
        f"{', '.join(f'{r:.1f}' for r in rps)} (median {out['rps']:.1f}); "
        f"p50 {out['p50_ms']:.2f} ms, p99 {out['p99_ms']:.2f} ms over all {n}")
    for p, ms in out["p50_ms_by_route"].items():
        log(f"    p50 {ms:8.2f} ms  {p}")
    log(f"  executor: {items} items in {batches} batches (mean {out['mean_batch']:.2f}), "
        f"largest group {max_group}; launches {launches}")
    log(f"  answers byte-identical to the same request alone: {identical} of {n} "
        f"(max {worst} LSB on the rest)")
    log(f"  profiled window: {out['profiled']['rps']:.1f} req/s; device busy {busy:.1f} us "
        f"of {prof_wall_us:.1f} us wall (share {out['profiled']['busy_share']:.4f}; "
        f"summed over streams {summed:.1f} us)")
    per_window = CLIENTS * PER_CLIENT
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {us / per_window:9.2f} us/request  {name[:90]}")
    torch.cuda.synchronize()
    return out


# --- phase 7: config 3, /pipeline on a 4K PNG to WEBP ------------------------

# bench_latency.py's exact chains: BASELINE.json config 3 on a 4K PNG, and
# the 1080p JPEG /pipeline
CONFIG3_OPS = [
    {"operation": "resize", "params": {"width": 1280}},
    {"operation": "blur", "params": {"sigma": 1.2}},
    {"operation": "watermark", "params": {"text": "bench", "opacity": 0.5}},
    {"operation": "convert", "params": {"type": "webp"}},
]
JPEG_PIPELINE_OPS = [
    {"operation": "crop", "params": {"width": 1600, "height": 900}},
    {"operation": "resize", "params": {"width": 640}},
    {"operation": "blur", "params": {"sigma": 1.5}},
    {"operation": "convert", "params": {"type": "jpeg"}},
]
BW_QUERY = {"width": "640", "colorspace": "bw"}
# (name, path, source, MIME type, decoded (h, w), requests served one at
# a time in the counted run)
CONFIG3_SERIAL = 5
CONFIG3_REQUESTS = (
    ("config3", "/pipeline?operations=" + urllib.parse.quote(json.dumps(CONFIG3_OPS)),
     "png", "image/webp", (720, 1280), CONFIG3_SERIAL),
    ("jpeg-pipeline", "/pipeline?operations=" + urllib.parse.quote(json.dumps(JPEG_PIPELINE_OPS)),
     "jpg", "image/jpeg", (360, 640), 3),
    ("bw-resize", "/resize?" + urllib.parse.urlencode(BW_QUERY), "jpg", "image/jpeg",
     (360, 640), 3),
)
CONFIG3_CLIENTS = 8
CONFIG3_PER_CLIENT = 2
CONFIG3_MAX_BATCH = 8
# The served WEBP (quality 80) against the same chain computed on the
# CPU: against the host's WEBP of the CPU array (the two arrays are at
# most 1 LSB apart, so the two encodes nearly agree), and against the CPU
# array itself (WEBP's own loss on this noisy pattern: 30.6 dB with
# Pillow 12.2 on the H100 machine's host)
CONFIG3_PSNR_VS_CPU_WEBP_DB = 40.0
CONFIG3_PSNR_VS_CPU_DB = 28.0
# launches of one stage of each spec
SPEC_LAUNCHES = {
    "SampleSpec": {"resample": 1}, "BlurSpec": {"blur": 1},
    "CompositeSpec": {"composite": 1}, "GraySpec": {"gray": 1},
    "ExtractSpec": {"gather": 1}, "EmbedSpec": {"gather": 1},
    "ShrinkBucketSpec": {"gather": 1}, "FromYuv420Spec": {"yuv420_unpack": 1},
    "ToYuv420Spec": {"yuv420_pack": 1}, "FlipSpec": {"orient": 1},
    "FlopSpec": {"orient": 1}, "TransposeSpec": {"orient": 1},
    "SmartExtractSpec": {"saliency": 2, "window_argmax": 1, "gather": 1},
    "FromDctSpec": {"from_dct": 1}, "ToDctSpec": {"to_dct": 1},
}


def make_4k_png() -> bytes:
    """bench_latency.py's 3840x2160 test pattern with seeded noise of +-3,
    as PNG (Pillow, zlib level 1)."""
    import io

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:CONFIG3_SRC[0], 0:CONFIG3_SRC[1]]
    img = np.stack([xx % 256, yy % 256, (xx // 16 + yy // 16) % 256], axis=-1)
    img = np.clip(img + rng.integers(-3, 4, size=img.shape), 0, 255).astype(np.uint8)
    out = io.BytesIO()
    Image.fromarray(img).save(out, "PNG", compress_level=1)
    return out.getvalue()


# Stages that read f32 only, and stages with no uint8 epilogue: an
# identity shrink next to one of them still launches (see expected_launches)
F32_ONLY_SPECS = ("ToYuv420Spec", "ToDctSpec")
NOT_LAST_SPECS = ("FromYuv420Spec", "FromDctSpec")
# The orientation stages: a run of them back to back is one K5 launch of
# their composed mode (the chain runner's fold)
ORIENT_SPECS = ("FlipSpec", "FlopSpec", "TransposeSpec")
# K5 launches of one /rotate?rotate=90 request (transpose, flop) and of
# one EXIF-6 /resize (transpose, flop, then K1)
ROTATE_ORIENT = 1
EXIF6_ORIENT = 1
# Pinned gather (K4) launches of one request: config 3's only gather is an
# identity shrink, /rotate?rotate=90's shrink changes the bucket
CONFIG3_GATHERS = 0
ROTATE_GATHERS = 1
# The bw /resize's K8 and K3 launches of one request: one fused K3
BW_GRAY = 0
BW_PACK = 1
BW_PROFILED = 6  # bw requests in phase 7's profiled window


def expected_launches(plan, arr) -> dict:
    """The launches of `plan` on input `arr` (a packed buffer, or an HWC
    frame padded to its bucket): every stage's, but the identity
    ShrinkBucketSpecs, whose output dims equal the bucket the stage before
    left, and a GraySpec right before a ToYuv420Spec, which that stage's
    K3 applies itself. Worked out here from the specs' own dims, apart
    from the chain runner's `live_stages` and `launch_steps`, so that the
    card's counts check the runner. A run of consecutive orientation
    stages counts one K5 launch (the runner's `orient_runs`)."""
    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.ops.buckets import bucket_shape

    hb, wb = arr.shape[:2] if plan.in_bucket is not None else bucket_shape(*arr.shape[:2])
    specs = plan.spec_key()
    names = [type(s).__name__ for s in specs]
    live = []
    for i, (spec, name) in enumerate(zip(specs, names)):
        if name == "TransposeSpec":
            out = (wb, hb)
        elif name in NOT_LAST_SPECS:
            out = (spec.hb, spec.wb)
        elif hasattr(spec, "out_hb"):
            out = (spec.out_hb, spec.out_wb)
        else:
            out = (hb, wb)
        if name == "ShrinkBucketSpec" and out == (hb, wb):
            nxt = names[i + 1] if i + 1 < len(names) else None
            if not ((not live and nxt in F32_ONLY_SPECS)
                    or (nxt is None and live and names[live[-1]] in NOT_LAST_SPECS)):
                continue
        live.append(i)
        hb, wb = out
    # a GraySpec right before a ToYuv420Spec launches nothing: that K3
    # applies the luma itself (one yuv420_pack launch for the pair)
    steps = []
    for i in live:
        if steps and names[i] == "ToYuv420Spec" and names[steps[-1]] == "GraySpec":
            steps[-1] = i
        else:
            steps.append(i)
    out = dict.fromkeys(kernels.LAUNCHES, 0)
    for k, i in enumerate(steps):
        if k and names[i] in ORIENT_SPECS and names[steps[k - 1]] in ORIENT_SPECS:
            continue  # one K5 launch for a run of orientation stages
        for name, n in SPEC_LAUNCHES[names[i]].items():
            out[name] += n
    return out


def check_bw_pins(bw_plan, bw_arr) -> None:
    """Hold expected_launches to the bw /resize's pinned launches: its K8
    folded into its K3."""
    got = expected_launches(bw_plan, bw_arr)
    if (got["gray"], got["yuv420_pack"]) != (BW_GRAY, BW_PACK):
        raise AssertionError(f"bw /resize plan: {got['gray']} gray and {got['yuv420_pack']} "
                             f"yuv420_pack launches, pinned {BW_GRAY} and {BW_PACK}")


def check_gather_pins(config3_plan, config3_arr) -> None:
    """Hold expected_launches to the pinned gather counts of config 3's
    plan and of /rotate?rotate=90's, and to the pinned K5 launches of
    /rotate?rotate=90's and of phase 6's EXIF-6 /resize (one each: the
    fold)."""
    got = expected_launches(config3_plan, config3_arr)["gather"]
    if got != CONFIG3_GATHERS:
        raise AssertionError(f"config 3 plan: {got} gathers, pinned {CONFIG3_GATHERS}")
    arr, p = main_plan("rotate", "yuv420", {"rotate": "90"})
    got = expected_launches(p, arr)
    if got["gather"] != ROTATE_GATHERS:
        raise AssertionError(f"/rotate plan: {got['gather']} gathers, pinned {ROTATE_GATHERS}")
    if got["orient"] != ROTATE_ORIENT:
        raise AssertionError(f"/rotate plan: {got['orient']} K5 launches, pinned {ROTATE_ORIENT}")
    with open(EXIF6_JPG, "rb") as f:
        arr, p = request_plan(f.read(), "resize", {"width": "120", "height": "90"})
    got = expected_launches(p, arr)["orient"]
    if got != EXIF6_ORIENT:
        raise AssertionError(f"EXIF-6 /resize plan: {got} K5 launches, pinned {EXIF6_ORIENT}")


def psnr(a, b) -> float:
    import numpy as np

    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def host_ms(fn, n: int = 5) -> float:
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def bw_profile(port: int, buf: bytes, want: int) -> dict:
    """The card's time and kernels a colorspace=bw /resize request: each of
    BW_PROFILED requests one at a time in its own torch.profiler window,
    the union of the card's busy intervals and the kernels (not the
    copies) by name. torch.profiler drops part of a window's device
    events now and then (see device_kernels): a window with fewer than
    `want` kernels (the plan's launches) is taken again, up to
    PROFILE_TRIES times, and the fullest one counts. Medians over the
    requests."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    path = "/resize?" + urllib.parse.urlencode(BW_QUERY)
    windows = []
    for _ in range(BW_PROFILED):
        best = None
        for _ in range(PROFILE_TRIES):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                status, ctype, _ = http(port, path, buf)
            if (status, ctype) != (200, "image/jpeg"):
                raise AssertionError(f"bw /resize: {status} {ctype}")
            busy, _, by_name = busy_union_us(prof)
            names = collections.Counter(
                kernel_name(e.name) for e in prof.events()
                if e.device_type == DeviceType.CUDA and "memcpy" not in e.name.lower()
                and "memset" not in e.name.lower())
            got = (sum(names.values()), busy, names, by_name)
            if best is None or got[0] > best[0]:
                best = got
            if best[0] >= want:
                break
        windows.append(best)
    full = [w for w in windows if w[0] >= want] or windows
    by_name: dict = collections.defaultdict(list)
    for _, _, _, names_us in full:
        for k, v in names_us.items():
            by_name[kernel_name(k)].append(v)
    return {"requests": BW_PROFILED, "full_windows": len([w for w in windows if w[0] >= want]),
            "busy_us_per_request": statistics.median(w[1] for w in full),
            "kernels_per_request": statistics.median(w[0] for w in windows),
            "kernels": dict(sum((w[2] for w in full), collections.Counter())),
            "by_name_us": {k: statistics.median(v) for k, v in by_name.items()}}


def config3_phase(png: bytes) -> dict:
    import io

    import numpy as np
    import torch
    from PIL import Image
    from torch.profiler import ProfilerActivity, profile

    from imaginary_tpu_torch import codecs, kernels
    from imaginary_tpu_torch.codecs import EncodeOptions, native_backend
    from imaginary_tpu_torch.imgtype import ImageType
    from imaginary_tpu_torch.ops import chain
    from imaginary_tpu_torch.ops.text import _load_font, _parse_font_spec, _resolve_font_path
    from imaginary_tpu_torch.web.app import make_server

    with open(LARGE_JPG, "rb") as f:
        bodies = {"png": png, "jpg": f.read()}
    font = _resolve_font_path(*_parse_font_spec("sans 12")[:3])
    log(f"  watermark font for 'sans 12': {font or 'none found'} "
        f"({type(_load_font('sans 12', 72)).__name__})")
    # the plans the server runs, and each chain's launches
    plans = {
        "config3": pipeline_request(png, CONFIG3_OPS, "rgb"),
        "jpeg-pipeline": pipeline_request(bodies["jpg"], JPEG_PIPELINE_OPS, "yuv420"),
        "bw-resize": main_plan("resize", "yuv420", BW_QUERY),
    }
    check_gather_pins(plans["config3"][1], plans["config3"][0])
    check_bw_pins(plans["bw-resize"][1], plans["bw-resize"][0])
    expected = dict.fromkeys(kernels.LAUNCHES, 0)
    for name, _, _, _, _, n in CONFIG3_REQUESTS:
        for k, v in expected_launches(plans[name][1], plans[name][0]).items():
            expected[k] += n * v
    srv = make_server("127.0.0.1", 0, device=DEVICE, max_batch=CONFIG3_MAX_BATCH,
                      batch_form_ms=CONFIG2_FORM_MS)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    ex = srv.service.executor
    lat: dict = {}
    last: dict = {}
    try:
        for _, path, src, _, _, _ in CONFIG3_REQUESTS:  # one untimed each
            http(port, path, bodies[src])
        kernels.reset_launches()
        for name, path, src, mime, dims, n in CONFIG3_REQUESTS:
            lat[name] = []
            for _ in range(n):
                t0 = time.perf_counter()
                status, ctype, body = http(port, path, bodies[src])
                lat[name].append((time.perf_counter() - t0) * 1e3)
                if (status, ctype) != (200, mime):
                    raise AssertionError(f"{name}: {status} {ctype}")
                if codecs.decode(body).array.shape[:2] != dims:
                    raise AssertionError(f"{name}: output is not {dims}")
            last[name] = body
        launches = kernels.launch_counts()
        bw = bw_profile(port, bodies["jpg"],
                        sum(expected_launches(plans["bw-resize"][1], plans["bw-resize"][0])
                            .values()))
        reqs = [(CONFIG3_REQUESTS[0][1], png)]
        items0, batches0 = ex.stats.items, ex.stats.batches
        walls, results = [], []
        for _ in range(WINDOWS):
            wall, got = load_window(port, reqs, CONFIG3_CLIENTS, CONFIG3_PER_CLIENT)
            walls.append(wall)
            results.extend(got)
        items, batches = ex.stats.items - items0, ex.stats.batches - batches0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            wall2, _ = load_window(port, reqs, CONFIG3_CLIENTS, CONFIG3_PER_CLIENT)
            prof_wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)
    if launches != expected:
        raise AssertionError(f"config 3 launches {launches}, the plans say {expected}")
    for name in CONFIG3_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on config 3's path")
    for _, _, status, ctype, body in results:
        if (status, ctype) != (200, "image/webp"):
            raise AssertionError(f"config 3 under load: {status} {ctype}")
    # the WEBP against the same chain computed on the CPU
    arr, p = plans["config3"]
    cpu = chain.run_single(arr, p, device="cpu")
    webp_opts = EncodeOptions(type=ImageType.WEBP)
    cpu_webp = codecs.encode(cpu, webp_opts)

    def pixels(body):
        return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))

    webp = pixels(last["config3"])
    db_webp, db = psnr(webp, pixels(cpu_webp)), psnr(webp, cpu)
    if db_webp < CONFIG3_PSNR_VS_CPU_WEBP_DB or db < CONFIG3_PSNR_VS_CPU_DB:
        raise AssertionError(
            f"config 3 WEBP: {db_webp:.2f} dB from the CPU array's WEBP (bound "
            f"{CONFIG3_PSNR_VS_CPU_WEBP_DB}), {db:.2f} dB from the CPU array (bound "
            f"{CONFIG3_PSNR_VS_CPU_DB})")
    # one request's host work, step by step on the host clock: decode,
    # plan (with the text raster), the chain on the card (staging, H2D,
    # kernels, D2H), encode
    from imaginary_tpu_torch import pipeline
    from imaginary_tpu_torch.params import build_params_from_query

    o3 = build_params_from_query({"operations": json.dumps(CONFIG3_OPS)})
    if {codecs.ROUTES[t] for t in (ImageType.PNG, ImageType.WEBP)} != {"native"}:
        raise AssertionError(f"config 3's codecs are not native: {codecs.routes()}")

    def pil_webp():
        out = io.BytesIO()
        Image.fromarray(cpu).save(out, "WEBP", quality=webp_opts.effective_quality())

    steps = {
        "png_decode": host_ms(lambda: native_backend.decode(png, ImageType.PNG)),
        "plan": host_ms(lambda: pipeline._build_pipeline_plan(
            o3, *CONFIG3_SRC, 0, 3, ImageType.PNG)),
        "chain_on_card": host_ms(lambda: chain.run_single(arr, p, device=DEVICE)),
        "webp_encode": host_ms(lambda: native_backend.encode(cpu, webp_opts)),
        # Pillow's calls on the same bytes, for the record only
        "png_decode_pillow": host_ms(
            lambda: np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))),
        "webp_encode_pillow": host_ms(pil_webp),
    }
    busy, summed, by_name = busy_union_us(prof)
    lat_load = [r[1] for r in results]
    rps = [CONFIG3_CLIENTS * CONFIG3_PER_CLIENT / w for w in walls]
    one = lat["config3"]
    out = {
        "serial_ms": lat, "launches": launches, "expected_launches": expected,
        "p50_ms_one_client": float(np.percentile(one, 50)),
        "p99_ms_one_client": float(np.percentile(one, 99)),
        "webp_psnr_db_vs_cpu": db, "webp_psnr_db_vs_cpu_webp": db_webp,
        "webp_identical_to_cpu_webp": last["config3"] == cpu_webp,
        "webp_max_abs_vs_cpu": int(np.abs(webp.astype(np.int32) - cpu.astype(np.int32)).max()),
        "png_bytes": len(png), "host_steps_ms": steps,
        "load": {"clients": CONFIG3_CLIENTS, "per_client": CONFIG3_PER_CLIENT,
                 "windows": WINDOWS, "wall_s": walls, "rps_by_window": rps,
                 "rps": statistics.median(rps),
                 "p50_ms": float(np.percentile(lat_load, 50)),
                 "p99_ms": float(np.percentile(lat_load, 99)),
                 "items": items, "batches": batches,
                 "mean_batch": items / batches if batches else 0.0},
        "profiled": {"wall_s": wall2, "rps": CONFIG3_CLIENTS * CONFIG3_PER_CLIENT / wall2,
                     "wall_us": prof_wall_us, "device_busy_us": busy,
                     "device_summed_us": summed, "busy_share": busy / prof_wall_us,
                     "by_name_us": by_name},
        "bw_profiled": bw,
        "font": font,
    }
    for name, ts in lat.items():
        log(f"  /{name} one at a time: p50 {np.percentile(ts, 50):.2f} ms "
            f"(n={len(ts)}; min {min(ts):.2f}, max {max(ts):.2f})")
    log(f"  config 3 one client: p50 {out['p50_ms_one_client']:.2f} ms, "
        f"p99 {out['p99_ms_one_client']:.2f} ms over {len(one)} requests")
    log(f"  launches: {launches} (as the plans say)")
    log(f"  bw /resize, {BW_PROFILED} requests profiled one at a time "
        f"({bw['full_windows']} windows with every kernel): card busy "
        f"{bw['busy_us_per_request']:.2f} us a request (median), "
        f"{bw['kernels_per_request']} kernels a request; median us a request: "
        + ", ".join(f"{k} {v:.2f}" for k, v in bw["by_name_us"].items()))
    log(f"  WEBP vs the CPU array's WEBP: PSNR {db_webp:.2f} dB (bytes identical: "
        f"{out['webp_identical_to_cpu_webp']}); vs the CPU array: PSNR {db:.2f} dB, "
        f"max {out['webp_max_abs_vs_cpu']} LSB")
    log(f"  host steps of one request (median of 5, host clock; PNG {len(png)} bytes): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in steps.items()))
    ld = out["load"]
    log(f"  {CONFIG3_CLIENTS} clients x {CONFIG3_PER_CLIENT} in {WINDOWS} windows: req/s "
        f"{', '.join(f'{r:.2f}' for r in rps)} (median {ld['rps']:.2f}); "
        f"p50 {ld['p50_ms']:.2f} ms, p99 {ld['p99_ms']:.2f} ms; "
        f"{items} items in {batches} batches")
    log(f"  profiled window: {out['profiled']['rps']:.2f} req/s; device busy {busy:.1f} us "
        f"of {prof_wall_us:.1f} us wall (share {out['profiled']['busy_share']:.4f}; "
        f"summed {summed:.1f} us)")
    per_window = CONFIG3_CLIENTS * CONFIG3_PER_CLIENT
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"    {us / per_window:9.2f} us/request  {name[:90]}")
    torch.cuda.synchronize()
    return out


# --- phase 3 (slice 4): K9-K12 against their plain versions -----------------

II_RTOL = 1e-5  # K9's integral image, relative per entry (sums in another order)
# K9's row pass on a W-shard (per-pixel saliency and segment totals)
# against its plain version on the card: relative and absolute per entry.
# The plain version's torch divides by a scalar through its reciprocal on
# the card, so its expf argument (up to ~120) may be an ulp off: ~1.4e-5
# relative on the skin term; the absolute term covers luma ulps in the
# edge term of near-zero pixels
SAL_MAP_RTOL = 1e-4
SAL_MAP_ATOL = 1e-6
WINDOW_RTOL = 1e-5  # a window's f64 saliency sum, relative
COEF_TOL = 1  # K12's int16 coefficients
COEF_SHARE = 1e-3  # at most this share of them may differ (rounding ties)
CONFIG4_FRAME = (320, 640)  # large.jpg's /smartcrop input bucket (300x533 valid)
CONFIG4_BATCHES = (1, 8)
CONFIG4_WINDOW = 300

# K9 and K10 at the seams of their designs (a K9 block scans a band of
# rows, each row by 256 threads in segments of ceil(Wb / 256) columns, and
# each column in 16 chunks of ceil(Hb / 16) rows; a K10 cluster scores only
# the windows inside the valid region and adds the first masked one):
# buckets narrower than 256 (empty segments), 257 wide (short last
# segments), heights of 8, 15 and 17 (empty chunks, chunks past the
# bucket), config 4's bucket, a 8192-wide bucket (one row a band) and a
# 2160x3840 frame; valid dims short of the bucket, one valid row, one
# valid column and a B=3 batch of mixed dims; windows equal to the valid
# dims (a single candidate), larger than them (all masked: (0, 0)) and
# 1x1; uint8 and f32, C = 3 and 4; and a flat red image, whose saliency
# is exactly 1 a valid pixel, so every window ties exactly and the first
# must win.
# (case, bucket, valid (h, w) per image, window (h, w) per image, C, uint8, flat)
SAL_SEAM_CASES = (
    ("8x8", (8, 8), ((8, 8),), ((3, 5),), 3, False, False),
    ("17x40", (17, 40), ((17, 40), (9, 33)), ((5, 12), (9, 7)), 3, False, False),
    ("15x257", (15, 257), ((15, 257), (14, 250)), ((6, 100), (14, 1)), 3, False, False),
    ("33x255-u8-C4", (33, 255), ((33, 255), (20, 129)), ((10, 255), (7, 64)), 4, True,
     False),
    ("320x640", (320, 640), ((300, 533), (320, 640)), ((300, 300), (1, 1)), 3, False,
     False),
    ("64x8192", (64, 8192), ((64, 8192), (37, 6001)), ((64, 300), (20, 5000)), 3, False,
     False),
    ("2160x3840", (2160, 3840), ((2160, 3840),), ((2160, 2160),), 3, False, False),
    ("short-dims-u8", (48, 64), ((45, 61), (31, 17)), ((20, 30), (31, 17)), 3, True,
     False),
    ("one-row", (24, 40), ((1, 40),), ((1, 10),), 3, False, False),
    ("one-col", (24, 40), ((24, 1),), ((7, 1),), 3, False, False),
    ("B3-mixed", (48, 64), ((45, 61), (48, 64), (1, 1)), ((20, 30), (48, 64), (1, 1)), 3,
     False, False),
    ("win-equal", (32, 48), ((29, 41), (32, 48)), ((29, 41), (32, 48)), 3, False, False),
    ("win-larger", (32, 48), ((29, 41), (32, 48)), ((30, 20), (10, 49)), 3, False, False),
    ("win-1x1-C4", (32, 48), ((29, 41), (32, 48)), ((1, 1), (1, 1)), 4, False, False),
    ("flat", (24, 40), ((24, 40), (17, 29)), ((8, 8), (17, 5)), 3, False, True),
)


def sal_seam_inputs(bucket: tuple, bsz: int, c: int, u8: bool, flat: bool, rng):
    """Seeded numpy input of a SAL_SEAM_CASES case: [B, hb, wb, c] noise
    uniform over 0-255 (uint8 or f32), or flat red (255, 0, 0), alpha 255."""
    import numpy as np

    hb, wb = bucket
    if flat:
        x = np.zeros((bsz, hb, wb, c), np.float32)
        x[..., 0] = 255.0
        if c == 4:
            x[..., 3] = 255.0
    else:
        x = rng.uniform(0.0, 255.0, (bsz, hb, wb, c))
    return x.astype(np.uint8) if u8 else x.astype(np.float32)


def sal_seam_tensors(case: tuple, rng, dev) -> tuple:
    """(x, h, w, win_h, win_w) of a SAL_SEAM_CASES case on dev."""
    import torch

    _, bucket, dims, wins, c, u8, flat = case

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    x = torch.from_numpy(sal_seam_inputs(bucket, len(dims), c, u8, flat, rng)).to(dev)
    return (x, i32([a for a, _ in dims]), i32([b for _, b in dims]),
            i32([a for a, _ in wins]), i32([b for _, b in wins]))


def sal_seams(res: dict) -> None:
    """K9 (within II_RTOL) and K10 (offsets equal, on K9's own integral
    image; (0, 0) on the flat image) on SAL_SEAM_CASES against their plain
    versions; case names start with "seam-"."""
    import numpy as np
    import torch

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.kernels import reference

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 11)
    for case in SAL_SEAM_CASES:
        name, flat = "seam-" + case[0], case[6]
        x, h, w, wh, ww = sal_seam_tensors(case, rng, dev)
        ii = kernels.saliency_ii(x, h, w)
        check_rel("saliency", ii, reference.saliency_ii(x, h, w), res, name, II_RTOL)
        top, left = kernels.window_argmax(ii, h, w, wh, ww)
        rt, rl = reference.window_argmax(ii, h, w, wh, ww)
        if not (torch.equal(top, rt) and torch.equal(left, rl)):
            raise AssertionError(f"window_argmax [{name}]: {top.tolist()} {left.tolist()} "
                                 f"against the plain {rt.tolist()} {rl.tolist()}")
        if flat and (top.any() or left.any()):
            raise AssertionError(f"window_argmax [{name}]: every window ties, yet "
                                 f"{top.tolist()} {left.tolist()}, not the first")
        res.setdefault("window_argmax", {})[name] = {
            "max_abs_err": 0.0, "top": top.tolist(), "left": left.tolist()}
        err = res["saliency"][name]
        log(f"  K9/K10 seam {case[0]}: ii max |err| {err['max_abs_err']!r} (relative "
            f"{err['max_rel_err']!r}); offsets {top.tolist()} {left.tolist()}, as the plain")
        del x, ii
    seams = {c: v for c, v in res["saliency"].items() if c.startswith("seam-")}
    worst = max(seams.items(), key=lambda kv: kv[1]["max_rel_err"])
    log(f"  saliency (redesigned): max relative err against the plain version over "
        f"{len(seams)} seam cases {worst[1]['max_rel_err']!r} ({worst[0][5:]}); "
        f"window_argmax: offsets equal on all {len(seams)}")


def check_rel(name, got, want, results, case, rtol):
    """Relative check per entry, |got - want| <= rtol |want|; records the
    largest absolute and relative errors."""
    d = (got.double() - want.double()).abs()
    rel = float((d / want.double().abs().clamp_min(1e-30)).max())
    if not bool((d <= rtol * want.double().abs()).all()):
        raise AssertionError(f"{name} [{case}]: max relative err {rel} > {rtol}")
    results.setdefault(name, {})[case] = {"max_abs_err": float(d.max()), "max_rel_err": rel}
    return rel


def config4_inputs(bsz: int, dev, gen) -> tuple:
    """(x, h, w): config 4's f32 [B, 320, 640, 3] input to SmartExtractSpec
    (large.jpg's bucket, 300x533 valid) as seeded noise with per-image
    valid dims and a bright disc each."""
    import torch

    hb, wb = CONFIG4_FRAME
    x = torch.rand((bsz, hb, wb, 3), generator=gen, device=dev) * 255.0
    i = torch.arange(bsz, dtype=torch.int32, device=dev)
    h = (300 + 2 * i).to(torch.int32)
    w = (533 - 29 * i).to(torch.int32)
    yy = torch.arange(hb, device=dev)[None, :, None]
    xx = torch.arange(wb, device=dev)[None, None, :]
    cy, cx = (60 + 20 * i)[:, None, None], (120 + 37 * i)[:, None, None]
    disc = ((yy - cy) ** 2 + (xx - cx) ** 2) <= 40 ** 2
    x = torch.where(disc[..., None], torch.tensor([230.0, 40.0, 40.0], device=dev), x)
    return x.contiguous(), h, w


# Windows taken for one call before device_kernels gives up on a trace
# with no device activity in it
PROFILE_TRIES = 5


def device_kernels(fn, want: int) -> list:
    """(name, us) of each device activity (kernel, copy, fill) that one
    call of fn puts on the card, from torch.profiler. A kernel launched as
    a programmatic dependent of the one before it counts the time it
    waited for that kernel. torch.profiler now and then drops all or part
    of a window's device events when it runs many times in one process,
    and never adds one: a window that recorded fewer than `want`
    activities is taken again, up to PROFILE_TRIES windows, and the
    fullest window comes back (so a call that really launches fewer or
    more than `want` still shows it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best: list = []
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        got = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == DeviceType.CUDA]
        if len(got) > len(best):
            best = got
        if len(best) >= want:
            break
    return best


def kernel_name(event: str) -> str:
    """A profiler kernel name without its namespace and arguments."""
    import re

    m = re.search(r"(\w+(?:<[^>]*>)?)\(", event)
    return m.group(1) if m else event


# the device kernels of one call of each wrapper: K9 its row pass and its
# column pass, K10 one cluster launch (no fill of a scratch before it)
CALL_KERNELS = {"saliency": 2, "window_argmax": 1}


def config4_kernel_phase(res: dict) -> None:
    """K9 and K10 at config 4's /smartcrop shape: the window chosen over
    f32 [B, 320, 640, 3] (`config4_inputs`). K10's offsets must equal the
    plain version's on K9's own integral image exactly. torch.profiler
    counts the device kernels of one call of each (CALL_KERNELS). No
    single PyTorch call computes either (the saliency terms and two
    prefix sums; a masked argmax over every window), so library_ms is
    null."""
    import torch

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.kernels import reference
    from imaginary_tpu_torch.ops import saliency as psal

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    hb, wb = CONFIG4_FRAME
    for bsz in CONFIG4_BATCHES:
        x, h, w = config4_inputs(bsz, dev, gen)
        case = f"B{bsz}"
        ii = kernels.saliency_ii(x, h, w)
        check_rel("saliency", ii, reference.saliency_ii(x, h, w), res, case, II_RTOL)
        # the plain version sums rows in K9's own order; hold K9 against
        # the reference's formulation too, cumsum over H, then over W
        sal = psal.saliency_map(x, h, w)
        h_first = torch.nn.functional.pad(torch.cumsum(torch.cumsum(sal, 1), 2), (1, 0, 1, 0))
        check_rel("saliency", ii, h_first, res, case + "-h-first", II_RTOL)
        del sal, h_first
        flops = 45.0 * bsz * hb * wb + 2.0 * bsz * hb * wb
        timing(res, "saliency", case, lambda x=x, h=h, w=w: kernels.saliency_ii(x, h, w),
               lambda x=x, h=h, w=w: reference.saliency_ii(x, h, w), None,
               x.numel() * 4 + ii.numel() * 4, flops)
        win = torch.full((bsz,), CONFIG4_WINDOW, dtype=torch.int32, device=dev)
        top, left = kernels.window_argmax(ii, h, w, win, win)
        rt, rl = reference.window_argmax(ii, h, w, win, win)
        if not (torch.equal(top, rt) and torch.equal(left, rl)):
            raise AssertionError(f"window_argmax [{case}]: {top.tolist()} {left.tolist()} "
                                 f"against the plain {rt.tolist()} {rl.tolist()}")
        res.setdefault("window_argmax", {})[case] = {"max_abs_err": 0.0,
                                                     "top": top.tolist(), "left": left.tolist()}
        # the ii entries the candidates read, once; 4 operations each
        work = [k10_work(int(a), int(b), CONFIG4_WINDOW, CONFIG4_WINDOW, hb, wb)
                for a, b in zip(h.tolist(), w.tolist())]
        timing(res, "window_argmax", case,
               lambda ii=ii, h=h, w=w, win=win: kernels.window_argmax(ii, h, w, win, win),
               lambda ii=ii, h=h, w=w, win=win: reference.window_argmax(ii, h, w, win, win),
               None, sum(b for b, _ in work), sum(f for _, f in work))
        for name, call in (("saliency", lambda: kernels.saliency_ii(x, h, w)),
                           ("window_argmax", lambda: kernels.window_argmax(ii, h, w, win, win))):
            kern = device_kernels(call, CALL_KERNELS[name])
            if len(kern) != CALL_KERNELS[name]:
                raise AssertionError(f"one {name} call [{case}] put {len(kern)} kernels on "
                                     f"the card ({kern}), not {CALL_KERNELS[name]}")
            res[name][case]["call_kernels"] = kern
            log(f"  one {name} call [{case}]: " + ", ".join(
                f"{kernel_name(n)} {us:.2f} us" for n, us in kern))
        xu = x.to(torch.uint8)
        check_rel("saliency", kernels.saliency_ii(xu, h, w), reference.saliency_ii(xu, h, w),
                  res, case + "-u8", II_RTOL)
        del x, xu, ii
    log(f"  one call's device kernels (torch.profiler): saliency "
        f"{len(res['saliency']['B1']['call_kernels'])}, window_argmax "
        f"{len(res['window_argmax']['B1']['call_kernels'])}")
    log("  saliency and window_argmax: no single-call library equivalent (saliency "
        "terms + two prefix sums; a masked argmax over every window): library_ms null")


def jpeg_of_large(layout: str) -> bytes:
    """large.jpg's pixels re-encoded by Pillow (libjpeg, quality 90) in a
    sampling layout."""
    import io

    from PIL import Image

    im = Image.open(LARGE_JPG).convert("RGB")
    out = io.BytesIO()
    if layout == "gray":
        im.convert("L").save(out, "JPEG", quality=90)
    else:
        im.save(out, "JPEG", quality=90, subsampling={"444": 0, "422": 1, "420": 2}[layout])
    return out.getvalue()


def idct_flops(layout: str, k: int, hb: int, wb: int) -> float:
    """K11's operations: a separable kv x kh IDCT is 2 (kh + kv)
    operations a coefficient of each region, then ~20 for the color
    conversion of each output pixel (the upsample included)."""
    from imaginary_tpu_torch import kernels

    total = 0.0
    for _, rows, _, cols, _, kv, kh in kernels.dct_regions(layout, k, hb, wb):
        total += 2.0 * (kv + kh) * rows * cols
    return total + 20.0 * hb * wb


def from_dct_cases(dev) -> list:
    """K11's inputs at the main paths' shapes, (case, x, h, w, hb, wb, k,
    layout): large.jpg's packed coefficients at 1080p 4:2:0 (k = 8) and
    at the main path's shrink 4 (k = 2), and its 4:2:2, 4:4:4 and gray
    re-encodes at k = 8."""
    import numpy as np
    import torch

    from imaginary_tpu_torch.codecs import jpeg_dct
    from imaginary_tpu_torch.ops.buckets import dct_packed_geometry

    with open(LARGE_JPG, "rb") as f:
        large = f.read()
    out = []
    for case, buf, shrink in (("1080p-420-k8", large, 1), ("main-420-k2", large, 4),
                              ("1080p-422-k8", jpeg_of_large("422"), 1),
                              ("1080p-444-k8", jpeg_of_large("444"), 1),
                              ("1080p-gray-k8", jpeg_of_large("gray"), 1)):
        packed, h2, w2, layout = jpeg_dct.decode_packed(buf, shrink)
        k, _, _, hb, wb = dct_packed_geometry(1080, 1920, shrink, layout)
        x = torch.from_numpy(np.ascontiguousarray(packed))[None].to(dev)
        h = torch.tensor([h2], dtype=torch.int32, device=dev)
        w = torch.tensor([w2], dtype=torch.int32, device=dev)
        out.append((case, x, h, w, hb, wb, k, layout))
    return out


def to_dct_cases(dev, rgb_1080) -> list:
    """K12's inputs, (case, x, h, w): phase 9's two /resize outputs (the
    chains' own RGB before their ToDctSpec, planned as the server plans
    them) and rgb_1080, K11's 1080p output cut to 1088x1920."""
    import torch

    with open(LARGE_JPG, "rb") as f:
        large = f.read()
    out = []
    for query in ({"width": "300", "height": "200"}, {"width": "1600"}):
        wrapped, packed, _ = dct_request_plan(large, "resize", query)
        x, h, w, _ = run_stages_until(packed, wrapped, "ToDctSpec", DEVICE)
        out.append((f"resize-{x.shape[1]}x{x.shape[2]}", x, h, w))
    out.append(("1088x1920", rgb_1080, torch.tensor([1080], dtype=torch.int32, device=dev),
                torch.tensor([1920], dtype=torch.int32, device=dev)))
    return out


def dct_kernel_phase(res: dict) -> None:
    """K11 on `from_dct_cases` and K12 on `to_dct_cases`. No single
    PyTorch call computes either (the IDCT with the chroma upsample and
    color convert; the color convert, 2x2 mean, FDCT and quantize), so
    library_ms is null."""
    import numpy as np
    import torch

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.codecs import jpeg_dct
    from imaginary_tpu_torch.kernels import reference

    dev = torch.device(DEVICE)
    rgb_1080 = None
    for case, x, h, w, hb, wb, k, layout in from_dct_cases(dev):
        got = kernels.from_dct(x, h, w, hb, wb, k, layout)
        check("from_dct", got, reference.from_dct(x, h, w, hb, wb, k, layout), res, case,
              F32_TOL)
        timing(res, "from_dct", case,
               lambda x=x, h=h, w=w, hb=hb, wb=wb, k=k, lay=layout:
               kernels.from_dct(x, h, w, hb, wb, k, lay),
               lambda x=x, h=h, w=w, hb=hb, wb=wb, k=k, lay=layout:
               reference.from_dct(x, h, w, hb, wb, k, lay),
               None, x.numel() * 2 + got.numel() * 4, idct_flops(layout, k, hb, wb))
        if case == "1080p-420-k8":
            rgb_1080 = got[:, :1088, :1920].contiguous()
        del x, got
    log("  from_dct and to_dct: no single-call library equivalent (IDCT + chroma "
        "upsample + BT.601; BT.601 + 2x2 mean + FDCT + quantize): library_ms null")
    qy, qc = jpeg_dct.quality_tables(80)
    for case, x, h, w in to_dct_cases(dev, rgb_1080):
        bsz, hb, wb, _ = x.shape
        q_y = torch.tensor(np.stack([qy] * bsz), dtype=torch.float32, device=dev)
        q_c = torch.tensor(np.stack([qc] * bsz), dtype=torch.float32, device=dev)
        got = kernels.to_dct(x, h, w, q_y, q_c, hb, wb)
        err = check_coef("to_dct", got, reference.to_dct(x, h, w, q_y, q_c, hb, wb), res, case)
        log(f"  to_dct {case}: max |diff| {err}, differing share "
            f"{res['to_dct'][case]['differing_share']:.3e}")
        # per pixel ~16 for the color convert and mean, per coefficient
        # 32 for the separable FDCT and 2 for the quantize
        flops = 16.0 * x.numel() / 3 + 34.0 * 1.5 * hb * wb * bsz
        timing(res, "to_dct", case,
               lambda x=x, h=h, w=w, a=q_y, b=q_c, hb=hb, wb=wb: kernels.to_dct(x, h, w, a, b, hb, wb),
               lambda x=x, h=h, w=w, a=q_y, b=q_c, hb=hb, wb=wb: reference.to_dct(x, h, w, a, b, hb, wb),
               None, x.numel() * 4 + got.numel() * 2, flops)


def run_stages_until(arr, plan, spec_name: str, device):
    """Run a plan's stages on `device` as the chain runs them, up to (not
    including) the first stage of class `spec_name`. Returns (x, h, w,
    that stage's dyn) as device tensors."""
    import numpy as np
    import torch

    from imaginary_tpu_torch.ops import chain

    dev = torch.device(device)
    if plan.in_bucket is not None:
        x, h, w = arr, plan.in_h, plan.in_w
    else:
        x, h, w = chain.pad_to_bucket(arr), arr.shape[0], arr.shape[1]
    x = torch.from_numpy(np.array(x))[None].to(dev)
    h = torch.tensor([h], dtype=torch.int32, device=dev)
    w = torch.tensor([w], dtype=torch.int32, device=dev)
    for st, dyn in zip(plan.stages, chain._stack_dyns([plan])):
        d = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in dyn.items()}
        if type(st.spec).__name__ == spec_name:
            return x, h, w, d
        x, h, w = st.spec.apply(x, h, w, d, out_u8=False)
    raise AssertionError(f"the plan has no {spec_name}")


def dct_request_plan(buf: bytes, op: str, query: dict, egress: bool = True):
    """(wrapped plan, packed coefficients, shrink) of `op` on the JPEG buf
    as the pipeline plans it with the dct transport and, when `egress`,
    its egress on (ToDctSpec last; else ToYuv420Spec)."""
    from imaginary_tpu_torch import codecs, pipeline
    from imaginary_tpu_torch.codecs import jpeg_dct
    from imaginary_tpu_torch.imgtype import ImageType
    from imaginary_tpu_torch.ops import plan as plan_mod
    from imaginary_tpu_torch.params import build_params_from_query

    o = build_params_from_query(query)
    meta = codecs.probe_fast(buf)
    shrink = pipeline._pick_shrink(op, ImageType.JPEG, o, meta)
    sh, sw = -(-meta.height // shrink), -(-meta.width // shrink)
    p = plan_mod.plan_operation(op, o, sh, sw, meta.orientation, 3)
    packed, _, _, layout = jpeg_dct.decode_packed(buf, shrink)
    wrapped = plan_mod.wrap_plan_dct(p, meta.height, meta.width, shrink, layout=layout,
                                     egress="dct" if egress else "",
                                     egress_quality=o.quality or 80)
    return wrapped, packed, shrink


# --- phase 8: config 4, /smartcrop on bench_firehose.py's stream -------------

CONFIG4_N = 24
CONFIG4_SEED = 11
CONFIG4_PATH = "/smartcrop?width=300&height=300"
CONFIG4_CLIENTS = 16
CONFIG4_PER_CLIENT = 3
CONFIG4_MAX_BATCH = 16
CONFIG4_MIME = {"JPEG": "image/jpeg", "PNG": "image/png", "WEBP": "image/webp"}


def make_config4_stream() -> list:
    """bench_firehose.py:_gen_stream(24, seed=11) with numpy and Pillow:
    the same draws from the same generator, so the same dims, patterns
    and disc (a filled white disc with a black core), as JPEG (quality
    95, 4:2:0), PNG and lossless WEBP in turn. The generator's arrays are
    BGR (it encodes with OpenCV); Pillow gets them as RGB. Returns
    [(bytes, format, (h, w))]."""
    import io

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(CONFIG4_SEED)
    out = []
    for i in range(CONFIG4_N):
        h = int(rng.integers(420, 780))
        w = int(rng.integers(560, 1100))
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = np.stack([
            128 + 90 * np.sin(xx / (23 + (i % 7))),
            128 + 90 * np.cos(yy / (29 + (i % 5))),
            (xx + yy) % 255,
        ], axis=-1)
        cy, cx = int(h * (0.3 + 0.4 * rng.random())), int(w * (0.3 + 0.4 * rng.random()))
        r = int(min(h, w) * 0.12)
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        base[d2 <= r * r] = 255.0
        base[d2 <= (r // 2) ** 2] = 0.0
        noise = rng.normal(0, 6, (h, w, 3))
        img = np.clip(base + noise, 0, 255).astype(np.uint8)[..., ::-1]
        fmt = ("JPEG", "PNG", "WEBP")[i % 3]
        buf = io.BytesIO()
        im = Image.fromarray(np.ascontiguousarray(img))
        if fmt == "JPEG":
            im.save(buf, fmt, quality=95, subsampling=2)
        elif fmt == "PNG":
            im.save(buf, fmt, compress_level=1)
        else:
            im.save(buf, fmt, lossless=True, quality=0, method=0)
        out.append((buf.getvalue(), fmt, (h, w)))
    return out


def request_plan(buf: bytes, op: str, query: dict):
    """(input array, plan) of `op` on buf as `pipeline.process_operation`
    routes it with the dct transport off: the packed 4:2:0 planes and the
    wrapped plan for a 4:2:0 JPEG, else the decoded frame and its plan."""
    from imaginary_tpu_torch import codecs, pipeline
    from imaginary_tpu_torch.imgtype import ImageType, determine_image_type
    from imaginary_tpu_torch.ops import plan as plan_mod
    from imaginary_tpu_torch.params import build_params_from_query

    o = build_params_from_query(query)
    t = determine_image_type(buf)
    meta = codecs.probe_fast(buf) if t is ImageType.JPEG else None
    shrink = pipeline._pick_shrink(op, t, o, meta)
    if pipeline._yuv_eligible(t, meta, o):
        sh, sw = -(-meta.height // shrink), -(-meta.width // shrink)
        packed, _, _ = pipeline._decode_yuv_packed(buf, shrink, sh, sw)
        p = plan_mod.plan_operation(op, o, sh, sw, meta.orientation, 3)
        return packed, plan_mod.wrap_plan_yuv420(p, sh, sw)
    d = codecs.decode(buf, shrink)
    return d.array, plan_mod.plan_operation(op, o, *d.array.shape[:2], d.orientation,
                                            d.array.shape[2])


def window_parity(stream: list) -> dict:
    """For every image of the stream: SmartExtractSpec's input as the chain
    computes it on the card and on the CPU, then the window on each (the
    kernels K9 + K10 on the card, the plain versions on the CPU). Offsets
    equal, or the card's window holds the CPU window's saliency (f64, on
    the CPU's map) within WINDOW_RTOL."""
    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.ops import saliency

    mismatches, worst = 0, 0.0
    for buf, _, _ in stream:
        arr, plan = request_plan(buf, "smartcrop", {"width": "300", "height": "300"})
        got = []
        for dev in (DEVICE, "cpu"):
            x, h, w, dyn = run_stages_until(arr, plan, "SmartExtractSpec", dev)
            ii = kernels.saliency_ii(x, h, w)
            t, lft = kernels.window_argmax(ii, h, w, dyn["new_h"], dyn["new_w"])
            got.append((int(t[0]), int(lft[0])))
        wh, ww = int(dyn["new_h"][0]), int(dyn["new_w"][0])
        if got[0] == got[1]:
            continue
        mismatches += 1
        sal = saliency.saliency_map(x, h, w)[0].double()
        sums = [float(sal[t:t + wh, lf:lf + ww].sum()) for t, lf in got]
        rel = abs(sums[0] - sums[1]) / sums[1]
        worst = max(worst, rel)
        if rel > WINDOW_RTOL:
            raise AssertionError(f"smartcrop window on the card {got[0]} holds {sums[0]}, "
                                 f"the CPU's {got[1]} {sums[1]} (relative {rel})")
    return {"images": len(stream), "offset_mismatches": mismatches,
            "worst_window_sum_rel": worst}


def config4_phase(stream: list) -> dict:
    import io

    import numpy as np
    import torch
    from PIL import Image
    from torch.profiler import ProfilerActivity, profile

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.web.app import make_server

    expected = dict.fromkeys(kernels.LAUNCHES, 0)
    for buf, _, _ in stream:
        arr, p = request_plan(buf, "smartcrop", {"width": "300", "height": "300"})
        for k, v in expected_launches(p, arr).items():
            expected[k] += v
    srv = make_server("127.0.0.1", 0, device=DEVICE, max_batch=CONFIG4_MAX_BATCH,
                      batch_form_ms=CONFIG2_FORM_MS)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    ex = srv.service.executor
    try:
        for buf, _, _ in stream:  # one untimed each
            http(port, CONFIG4_PATH, buf)
        kernels.reset_launches()
        alone, lat_one = [], []
        for buf, fmt, _ in stream:
            t0 = time.perf_counter()
            status, ctype, body = http(port, CONFIG4_PATH, buf)
            lat_one.append((time.perf_counter() - t0) * 1e3)
            if (status, ctype) != (200, CONFIG4_MIME[fmt]):
                raise AssertionError(f"/smartcrop on a {fmt}: {status} {ctype}")
            alone.append(body)
        launches = kernels.launch_counts()
        reqs = [(CONFIG4_PATH, buf) for buf, _, _ in stream]
        items0, batches0 = ex.stats.items, ex.stats.batches
        walls, results = [], []
        for _ in range(WINDOWS):
            wall, got = load_window(port, reqs, CONFIG4_CLIENTS, CONFIG4_PER_CLIENT)
            walls.append(wall)
            results.extend(got)
        items, batches = ex.stats.items - items0, ex.stats.batches - batches0
        max_group = ex.stats.max_group_seen
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            wall2, _ = load_window(port, reqs, CONFIG4_CLIENTS, CONFIG4_PER_CLIENT)
            prof_wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)
    if launches != expected:
        raise AssertionError(f"config 4 launches {launches}, the plans say {expected}")
    for name in CONFIG4_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on config 4's path")
    for body in alone:
        im = Image.open(io.BytesIO(body))
        if im.size != (300, 300):
            raise AssertionError(f"/smartcrop answered {im.size}, not 300x300")
    differing = 0
    for k, _, status, ctype, body in results:
        if (status, ctype) != (200, CONFIG4_MIME[stream[k][1]]):
            raise AssertionError(f"/smartcrop under load: {status} {ctype}")
        if body != alone[k]:
            differing += 1
    if differing:
        raise AssertionError(f"{differing} answers under load differ from the same "
                             "request served alone")
    parity = window_parity(stream)
    busy, summed, by_name = busy_union_us(prof)
    lat = [r[1] for r in results]
    per_window = CONFIG4_CLIENTS * CONFIG4_PER_CLIENT
    rps = [per_window / w for w in walls]
    out = {
        "stream": {"images": len(stream), "formats": [s[1] for s in stream],
                   "dims": [s[2] for s in stream], "bytes": sum(len(s[0]) for s in stream)},
        "launches": launches, "expected_launches": expected,
        "p50_ms_one_client": float(np.percentile(lat_one, 50)),
        "p99_ms_one_client": float(np.percentile(lat_one, 99)),
        "load": {"clients": CONFIG4_CLIENTS, "per_client": CONFIG4_PER_CLIENT,
                 "windows": WINDOWS, "wall_s": walls, "rps_by_window": rps,
                 "rps": statistics.median(rps),
                 "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
                 "items": items, "batches": batches,
                 "mean_batch": items / batches if batches else 0.0, "max_group_seen": max_group},
        "identical_to_alone": len(results),
        "profiled": {"wall_s": wall2, "rps": per_window / wall2, "wall_us": prof_wall_us,
                     "device_busy_us": busy, "device_summed_us": summed,
                     "busy_share": busy / prof_wall_us, "by_name_us": by_name},
        "window_parity": parity,
    }
    log(f"  stream: {len(stream)} images ({out['stream']['bytes']} bytes), "
        + ", ".join(f"{f} {h}x{w}" for _, f, (h, w) in stream[:6]) + ", ...")
    log(f"  one at a time: p50 {out['p50_ms_one_client']:.2f} ms, "
        f"p99 {out['p99_ms_one_client']:.2f} ms over {len(lat_one)} requests; "
        f"launches {launches} (as the plans say)")
    ld = out["load"]
    log(f"  {CONFIG4_CLIENTS} clients x {CONFIG4_PER_CLIENT} in {WINDOWS} windows: req/s "
        f"{', '.join(f'{r:.1f}' for r in rps)} (median {ld['rps']:.1f}); "
        f"p50 {ld['p50_ms']:.2f} ms, p99 {ld['p99_ms']:.2f} ms; {items} items in "
        f"{batches} batches (mean {ld['mean_batch']:.2f}, largest group {max_group}); "
        f"all {len(results)} answers byte-equal to the same request alone")
    log(f"  profiled window: {out['profiled']['rps']:.1f} req/s; device busy {busy:.1f} us "
        f"of {prof_wall_us:.1f} us wall (share {out['profiled']['busy_share']:.4f}; "
        f"summed {summed:.1f} us)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {us / per_window:9.2f} us/request  {name[:90]}")
    log(f"  window offsets card vs CPU: {parity['offset_mismatches']} of {parity['images']} "
        f"differ (worst window-sum difference {parity['worst_window_sum_rel']:.2e} "
        f"relative, bound {WINDOW_RTOL})")
    torch.cuda.synchronize()
    return out


# --- phase 9: the DCT transport both ways ------------------------------------

# (path, query, decoded output (h, w), requests in the counted run)
DCT_REQUESTS = (
    ("/resize?width=300&height=200", {"width": "300", "height": "200"}, (200, 300), 3),
    ("/resize?width=1600", {"width": "1600"}, (900, 1600), 3),
)


def coefficient_parity(card: bytes, cpu: bytes, dims: tuple, margin: int = 0) -> dict:
    """Two egress JPEGs of one request: their quantized coefficients
    (entropy-decoded back) within COEF_TOL with at most COEF_SHARE
    differing, and their decoded pixels within 1 LSB wherever a 16x16
    MCU's coefficients agree, and those of the `margin` rings of MCUs
    around it (the decoder's fancy chroma upsampling reads the next
    MCU's chroma at an MCU's edge)."""
    import io

    import numpy as np
    from PIL import Image

    from imaginary_tpu_torch.codecs import jpeg_dct

    a = jpeg_dct.decode_coefficients(card)
    b = jpeg_dct.decode_coefficients(cpu)
    if a is None or b is None or (a.h, a.w) != (b.h, b.w) != dims:
        raise AssertionError("egress JPEG is not a baseline 4:2:0 stream of the right size")
    worst, n_diff, n_all, eq = 0, 0, 0, None
    for pa, pb in zip(a.planes, b.planes):
        d = np.abs(pa.astype(np.int32) - pb.astype(np.int32))
        worst = max(worst, int(d.max()))
        n_diff += int((d > 0).sum())
        n_all += d.size
        same = (d == 0).all(axis=(2, 3))
        if eq is None:
            same = same[0::2, 0::2] & same[1::2, 0::2] & same[0::2, 1::2] & same[1::2, 1::2]
        eq = same if eq is None else eq & same
    share = n_diff / n_all
    for _ in range(margin):
        pad = np.pad(eq, 1, constant_values=True)
        eq = np.logical_and.reduce([pad[1 + dy: pad.shape[0] - 1 + dy,
                                        1 + dx: pad.shape[1] - 1 + dx]
                                    for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    if worst > COEF_TOL or share > COEF_SHARE:
        raise AssertionError(f"egress coefficients: max {worst}, {share:.2e} differ")
    pa = np.asarray(Image.open(io.BytesIO(card)).convert("RGB")).astype(np.int32)
    pb = np.asarray(Image.open(io.BytesIO(cpu)).convert("RGB")).astype(np.int32)
    mask = np.kron(eq, np.ones((16, 16), bool))[: pa.shape[0], : pa.shape[1]]
    lsb = int(np.abs(pa - pb).max(axis=2)[mask].max()) if mask.any() else 0
    if lsb > U8_TOL:
        raise AssertionError(f"egress pixels {lsb} LSB apart where the coefficients agree")
    return {"max_coef_diff": worst, "differing_share": share,
            "mcus_equal_share": float(eq.mean()), "max_lsb_where_equal": lsb,
            "bytes_identical": card == cpu}


def dct_phase(png: bytes) -> dict:
    import torch

    from imaginary_tpu_torch import codecs, kernels, pipeline
    from imaginary_tpu_torch.codecs import jpeg_dct
    from imaginary_tpu_torch.ops import chain
    from imaginary_tpu_torch.params import build_params_from_query
    from imaginary_tpu_torch.web.app import make_server

    with open(LARGE_JPG, "rb") as f:
        buf = f.read()
    plans = {path: dct_request_plan(buf, "resize", q) for path, q, _, _ in DCT_REQUESTS}
    expected = dict.fromkeys(kernels.LAUNCHES, 0)
    for path, _, _, n in DCT_REQUESTS:
        for k, v in expected_launches(plans[path][0], plans[path][1]).items():
            expected[k] += n * v
    srv = make_server("127.0.0.1", 0, device=DEVICE, transport_dct=True,
                      transport_dct_egress=True)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    lat: dict = {}
    last: dict = {}
    try:
        for path, _, _, _ in DCT_REQUESTS:  # one untimed each
            http(port, path, buf)
        counts0 = pipeline.dct_counts()
        kernels.reset_launches()
        for path, _, dims, n in DCT_REQUESTS:
            lat[path] = []
            for _ in range(n):
                t0 = time.perf_counter()
                status, ctype, body = http(port, path, buf)
                lat[path].append((time.perf_counter() - t0) * 1e3)
                if (status, ctype) != (200, "image/jpeg"):
                    raise AssertionError(f"dct {path}: {status} {ctype}")
                if codecs.decode(body).array.shape[:2] != dims:
                    raise AssertionError(f"dct {path}: output is not {dims}")
            last[path] = body
        launches = kernels.launch_counts()
        counts = {k: v - counts0[k] for k, v in pipeline.dct_counts().items()}
        decoder = jpeg_dct.decoder_name()
        # the same requests through the plain versions on the CPU, with
        # the same switches (still on)
        parity = {}
        for path, q, dims, _ in DCT_REQUESTS:
            cpu = pipeline.process_operation("resize", buf, build_params_from_query(q),
                                             device="cpu")
            parity[path] = coefficient_parity(last[path], cpu.body, dims)
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)
        pipeline.set_transport_dct(False)
        pipeline.set_transport_dct_egress(False)
    if launches != expected:
        raise AssertionError(f"dct launches {launches}, the plans say {expected}")
    for name in DCT_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the dct path")
    n_req = sum(n for _, _, _, n in DCT_REQUESTS)
    if counts != {"served": n_req, "out_of_scope": 0}:
        raise AssertionError(f"dct transport counts {counts}: every request must ride it")
    if decoder != "native":
        raise AssertionError(f"entropy decode ran on the {decoder} arm, not native")
    # one request's host steps, on the host clock (median of 5)
    steps = {}
    for path, _, _, _ in DCT_REQUESTS:
        wrapped, packed, shrink = plans[path]
        qb = chain.run_single(packed, wrapped, device=DEVICE)
        steps[path] = {
            "entropy_decode": host_ms(lambda s=shrink: jpeg_dct.decode_packed(buf, s)),
            "chain_on_card": host_ms(lambda p=packed, wp=wrapped: chain.run_single(p, wp,
                                                                                  device=DEVICE)),
            "entropy_encode": host_ms(lambda qb=qb: jpeg_dct.encode_quantized(qb)),
        }
    out = {"serial_ms": lat, "launches": launches, "expected_launches": expected,
           "counts": counts, "decoder": decoder, "parity": parity, "host_steps_ms": steps}
    for path, ts in lat.items():
        log(f"  {path}: {', '.join(f'{t:.2f}' for t in ts)} ms")
    log(f"  launches {launches} (as the plans say); counts {counts}; entropy arm {decoder}")
    for path, p in parity.items():
        log(f"  {path} vs the CPU: coefficients max |diff| {p['max_coef_diff']}, differing "
            f"share {p['differing_share']:.3e}; {p['mcus_equal_share']:.4f} of MCUs equal, "
            f"max {p['max_lsb_where_equal']} LSB there; bytes identical {p['bytes_identical']}")
    for path, st in steps.items():
        log(f"  host steps of {path} (median of 5): "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in st.items()))
    torch.cuda.synchronize()
    out["fanout"] = dct_fanout_phase(png)
    return out


# Phase 9's restart-segmented sources: phase 10(d)'s 8000x6000 4:2:0 frame
# and large.jpg, each saved with a restart marker after every MCU row, so
# the host's entropy decode fans its segments out across the request pool.
# /resize?width=3000 on the 48 MP frame is shrink 2 (K11 at k = 4 -> K1 ->
# K3, egress off); the python arm decodes only large.jpg.
FANOUT_48MP = ((8000, 6000), "/resize?width=3000", {"width": "3000"}, (2250, 3000))
FANOUT_LARGE = ("/resize?width=300&height=200", {"width": "300", "height": "200"}, (200, 300))
FANOUT_TIMED = 5


def dct_fanout_phase(png: bytes) -> dict:
    """--transport-dct servers with --dct-native native, numpy and python
    (the native one timed), each with its request pool registered as the
    segment pool, as served; then the native server with the pool
    detached (a serial decode). Every answer of a source must be the same
    bytes, and the card's launches those of the plans."""
    import io

    from PIL import Image

    from imaginary_tpu_torch import codecs, kernels
    from imaginary_tpu_torch.codecs import jpeg_dct
    from imaginary_tpu_torch.web.app import make_server

    size, path48, q48, dims48 = FANOUT_48MP
    big = make_4k_jpeg(png, size=size, restart_marker_rows=1)
    out = io.BytesIO()
    with Image.open(LARGE_JPG) as im:
        im.convert("RGB").save(out, "JPEG", quality=SPATIAL_JPEG_QUALITY, subsampling=2,
                               restart_marker_rows=1)
    large = out.getvalue()
    pathl, ql, dimsl = FANOUT_LARGE
    srcs = {path48: (big, q48, dims48), pathl: (large, ql, dimsl)}
    nseg = {p: len(jpeg_dct._split_scan_bounds(b, jpeg_dct._parse(b).entropy_pos))
            for p, (b, _, _) in srcs.items()}
    plan_launches = {p: expected_launches(*dct_request_plan(b, "resize", q, egress=False)[:2])
                     for p, (b, q, _) in srcs.items()}
    bodies: dict = {p: {} for p in srcs}
    lat: dict = {}
    served: list = []

    def get(port: int, path: str, label: str) -> float:
        buf, _, dims = srcs[path]
        t0 = time.perf_counter()
        status, ctype, body = http(port, path, buf)
        ms = (time.perf_counter() - t0) * 1e3
        if (status, ctype) != (200, "image/jpeg"):
            raise AssertionError(f"fan-out {label} {path}: {status} {ctype}")
        if codecs.decode(body).array.shape[:2] != dims:
            raise AssertionError(f"fan-out {label} {path}: output is not {dims}")
        bodies[path].setdefault(label, set()).add(body)
        served.append(path)
        return ms

    decode_ms: dict = {}
    kernels.reset_launches()
    for arm in ("native", "numpy", "python"):
        # the 48 MP source passes the pixel gate as in phase 10(d)
        srv = make_server("127.0.0.1", 0, device=DEVICE, transport_dct=True, dct_native=arm,
                          max_allowed_pixels=SPATIAL_DCT_MAX_MP)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            port = srv.server_address[1]
            pool = srv.app["service"].pool
            if jpeg_dct._SEGMENT_POOL is not pool:
                raise AssertionError(f"the {arm} server's pool is not the segment pool")
            if jpeg_dct.decoder_name(nseg[path48]) != arm:
                raise AssertionError(f"--dct-native {arm} resolved to "
                                     f"{jpeg_dct.decoder_name(nseg[path48])}")
            get(port, pathl, arm)
            if arm == "native":
                get(port, path48, arm)  # untimed
                lat[arm] = [get(port, path48, arm) for _ in range(FANOUT_TIMED)]
                decode_ms["fanned_out"] = host_ms(
                    lambda: jpeg_dct.decode_coefficients(big, decoder="native"))
                jpeg_dct.set_segment_pool(None)
                decode_ms["serial"] = host_ms(
                    lambda: jpeg_dct.decode_coefficients(big, decoder="native"))
                lat["serial"] = [get(port, path48, "serial")]
                get(port, pathl, "serial")
                decode_ms["workers"] = srv.app["service"].pool_workers
            elif arm == "numpy":
                lat[arm] = [get(port, path48, arm)]
        finally:
            srv.shutdown()
            srv.server_close()
            th.join(timeout=10)
            jpeg_dct.set_decoder("auto")
    launches = kernels.launch_counts()
    expected = dict.fromkeys(kernels.LAUNCHES, 0)
    for path in served:
        for k, v in plan_launches[path].items():
            expected[k] += v
    if launches != expected or launches["from_dct"] <= 0:
        raise AssertionError(f"fan-out launches {launches}, the plans say {expected} "
                             f"({len(served)} requests)")
    for path, got in bodies.items():
        distinct = set().union(*got.values())
        if len(distinct) != 1:
            raise AssertionError(f"fan-out {path}: {len(distinct)} distinct answers across "
                                 f"{sorted(got)}")
    p50 = {k: statistics.median(v) for k, v in lat.items()}
    log(f"  fan-out: {size[0]}x{size[1]} 4:2:0 JPEG with {nseg[path48]} restart segments "
        f"({len(big)} bytes), large.jpg with {nseg[pathl]}; {len(served)} requests, every "
        f"answer of a source the same bytes across {sorted(bodies[path48])} and "
        f"{sorted(bodies[pathl])}; launches as the plans say (K11 {launches['from_dct']})")
    log(f"  fan-out: entropy decode of the 48 MP scan (median of 5, host clock): serial "
        f"{decode_ms['serial']:.2f} ms, fanned out over {decode_ms['workers']} workers "
        f"{decode_ms['fanned_out']:.2f} ms")
    log(f"  fan-out: {path48} p50 " + ", ".join(f"{k} {v:.2f} ms" for k, v in p50.items())
        + f" (native: {', '.join(f'{t:.2f}' for t in lat['native'])} ms)")
    return {"segments": nseg, "jpeg_bytes": len(big), "requests": len(served),
            "launches": launches, "entropy_decode_ms": decode_ms, "latency_ms": lat,
            "p50_ms": p50}


# --- phase 10: multi-GPU serving and the W-sharded blur ---------------------

SHARDED_X = (2, 2160, 3840, 3)  # f32, two 4K frames
# image 0's valid region ends inside the last shard; image 1's at a seam
SHARDED_VALID = ((2100, 3800), (2160, 1920))
SHARDED_CASES = ((8, 3.0), (64, 20.0))  # (radius, sigma)
SHARDED_MESHES = ((1, 4), (2, 2))  # over four entries of one card
SHARDED_U8 = (1, 2160, 3840, 3)
# The spatial route's row: four entries of card 0 (phase 10(d)), and the
# shards of phase 3's K1 shard-form check
SPATIAL_SHARDS = 4
LANE_ENTRIES = 4
LANE_SHARD_MIN = 4


def shard_count(mesh, bsz: int) -> int:
    """Shards a sharded_blur call makes: batch rows that own an image,
    times the spatial axis."""
    from imaginary_tpu_torch.parallel import split_batch

    return sum(1 for a, b in split_batch(bsz, mesh) if a < b) * mesh.shape[1]


def sharded_blur_phase(res: dict) -> dict:
    """Phase 10(a): K13 (one fused launch a shard) against its plain
    version at every shard of the path's shapes and sharded_blur against
    K6 on the unsharded image (kernel, bit for bit, and plain), on meshes
    (1, 4) and (2, 2) over four entries of one card (and over real cards
    when there are several), at r = 8 and r = 64. The counted run: one
    sharded_blur call per mesh at r = 8, launches reset just before and
    read just after: one K13 launch a shard, no other kernel."""
    import torch

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.kernels import reference
    from imaginary_tpu_torch.parallel import get_mesh, spatial

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    bsz, hb, wb, c = SHARDED_X
    x = torch.rand(SHARDED_X, generator=gen, device=dev) * 255.0
    h = torch.tensor([v[0] for v in SHARDED_VALID[:bsz]], dtype=torch.int32, device=dev)
    w = torch.tensor([v[1] for v in SHARDED_VALID[:bsz]], dtype=torch.int32, device=dev)
    meshes = [(f"{b}x{s}", get_mesh(devices=[dev] * (b * s), spatial=s))
              for b, s in SHARDED_MESHES]
    cards = torch.cuda.device_count() if DEVICE == "cuda" else 1
    if cards > 1:
        k = max(n for n in range(2, cards + 1) if wb % n == 0)
        devs = [torch.device("cuda", i) for i in range(k)]
        meshes.append((f"cards1x{k}", get_mesh(devices=devs, spatial=k)))
        if k % 2 == 0:
            meshes.append((f"cards2x{k // 2}", get_mesh(devices=devs, spatial=k // 2)))
    out: dict = {"shape": list(SHARDED_X), "valid": [list(v) for v in SHARDED_VALID],
                 "meshes": [n for n, _ in meshes], "cards": cards}

    r0, sig0 = SHARDED_CASES[0]
    s0 = torch.full((bsz,), sig0, device=dev)
    spatial.sharded_blur(x, h, w, s0, r0, meshes[0][1])  # first use: build and load
    torch.cuda.synchronize()
    kernels.reset_launches()
    counted = {name: spatial.sharded_blur(x, h, w, s0, r0, mesh) for name, mesh in meshes}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    expected = sum(shard_count(mesh, bsz) for _, mesh in meshes)
    if launches["blur_halo"] != expected:
        raise AssertionError(f"blur_halo launched {launches['blur_halo']} times in "
                             f"the counted run, expected {expected} (one a shard)")
    if any(n for k, n in launches.items() if k != "blur_halo"):
        raise AssertionError(f"sharded_blur launched other kernels: {launches}")
    out["launches"] = launches
    log(f"  counted run: {len(meshes)} sharded_blur calls at r={r0}, launches {launches}")

    for r, sig in SHARDED_CASES:
        s = torch.full((bsz,), sig, device=dev)
        k6 = kernels.blur(x, h, w, s, r)
        plain6 = reference.blur(x, h, w, s, r)
        check("blur", k6, plain6, res, f"4K-B{bsz}-r{r}", F32_TOL)
        for name, mesh in meshes:
            case = f"{name}-r{r}"
            got = counted[name] if r == r0 else spatial.sharded_blur(x, h, w, s, r, mesh)
            err = check("blur_halo", got, k6, res, case + "-vs-K6", F32_TOL)
            check("blur_halo", got, plain6, res, case + "-vs-plain-K6", F32_TOL)
            if not torch.equal(got, k6):
                raise AssertionError(f"K13 [{case}] is not bit-equal to K6 "
                                     f"(max |diff| {err})")
            log(f"  K13 vs K6 [{case}]: max |diff| {err!r}, bit-equal True")
            # the kernel against its plain version, shard by shard, after
            # the exchange, on every device's current stream
            grid = spatial.shard_inputs(
                x, h, w, s, mesh, [torch.cuda.current_stream(d) if d.type == "cuda"
                                   else None for d in mesh.flat])
            shards = [sh for row in grid for sh in row]
            spatial.exchange_halos(grid, r)

            def k13(fn, shards=shards, r=r):
                return [fn(sh.x, sh.left, sh.right, sh.h, sh.w, sh.sigma, r, sh.col0, wb)
                        for sh in shards]

            check_all("blur_halo", list(zip(k13(kernels.blur_halo),
                                            k13(reference.blur_halo))),
                      res, case + "-shards", F32_TOL)
            if name.startswith("cards"):
                continue
            ms = device_ms(lambda: k13(kernels.blur_halo))
            ms_x = device_ms(lambda: spatial.exchange_halos(grid, r))
            plain = device_ms(lambda: k13(reference.blur_halo), calls=3, reps=3)
            whole = device_ms(lambda: spatial.sharded_blur(x, h, w, s, r, mesh))
            whole_call = call_ms(lambda: spatial.sharded_blur(x, h, w, s, r, mesh))
            k6_ms = device_ms(lambda: kernels.blur(x, h, w, s, r))
            strips = sum(2 * (len(row) - 1) * (row[0].b1 - row[0].b0) for row in grid)
            x_bytes = 2 * strips * hb * r * c * 4  # each strip read once, written once
            nbytes = x.numel() * 4 + got.numel() * 4
            b, by = bound_ms(nbytes, blur_flops(h, w, r, c))
            bx, _ = bound_ms(x_bytes, 0.0)
            res["blur_halo"][case + "-vs-K6"].update({
                "ms": ms, "exchange_ms": ms_x, "exchange_bytes": x_bytes,
                "exchange_bound_ms": bx, "sharded_blur_ms": whole,
                "sharded_blur_call_ms": whole_call, "k6_ms": k6_ms, "ms_over_k6": ms / k6_ms,
                "plain_ms": plain, "bound_ms": b, "bound_by": by, "library_ms": None,
                "bytes": nbytes, "shards": len(shards)})
            log(f"  blur_halo {case:8s} err {res['blur_halo'][case + '-vs-K6']['max_abs_err']:.3g}"
                f"  K13 {ms:.4f} ms (all {len(shards)} shard launches, one stream; "
                f"{ms / k6_ms:.2f}x K6)  exchange {ms_x:.4f} ms ({x_bytes / 1e6:.2f} MB, "
                f"bound {bx:.4f})  sharded_blur {whole:.4f} ms device, {whole_call:.4f} ms "
                f"call  K6 {k6_ms:.4f} ms  plain {plain:.4f} ms  bound {b:.4f} ms ({by})")
            del grid, shards
        del k6, plain6
    xu = torch.randint(0, 256, SHARDED_U8, generator=gen, device=dev, dtype=torch.uint8)
    n = SHARDED_U8[0]
    su = torch.full((n,), SHARDED_CASES[0][1], device=dev)
    got = spatial.sharded_blur(xu, h[:n], w[:n], su, r0, meshes[0][1])
    k6u = kernels.blur(xu, h[:n], w[:n], su, r0)
    check("blur_halo", got, k6u, res, f"{meshes[0][0]}-u8-vs-K6", F32_TOL)
    check("blur_halo", got, reference.blur(xu, h[:n], w[:n], su, r0), res,
          f"{meshes[0][0]}-u8-vs-plain-K6", F32_TOL)
    if not torch.equal(got, k6u):
        raise AssertionError("K13 on a uint8 frame is not bit-equal to K6")
    log("  blur_halo: no single-call library equivalent (per-image masked taps "
        "over W-shards with halos): library_ms null")
    torch.cuda.synchronize()
    return out


def start(srv):
    """srv serving on a thread; returns the function that stops and
    closes it."""
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()

    def stop():
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)

    return stop


def serving(srv, fn):
    """fn(srv) with srv serving on a thread; the server is closed after."""
    stop = start(srv)
    try:
        return fn(srv)
    finally:
        stop()


def alone_bodies(srv, bodies: dict) -> list:
    """Each phase 6 route's answer served alone (after one warm request)."""
    port = srv.server_address[1]
    out = []
    for path, src, _ in CONFIG2_REQUESTS:
        http(port, path, bodies[src])
        status, ctype, body = http(port, path, bodies[src])
        if (status, ctype) != (200, "image/jpeg"):
            raise AssertionError(f"{path} alone: {status} {ctype}")
        out.append(body)
    return out


def serve_mix(srv, bodies: dict, want: list, windows: int = WINDOWS) -> dict:
    """Phase 6's mix from CLIENTS threads in `windows` timed windows against
    a started server, with the launch counters and the stage times set to
    0 just before and read just after; every answer must be byte-equal to
    `want`."""
    import numpy as np

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.engine.timing import TIMES

    port = srv.server_address[1]
    reqs = [(path, bodies[src]) for path, src, _ in CONFIG2_REQUESTS]
    for path, body in reqs:  # warm each route
        http(port, path, body)
    ex = srv.service.executor
    items0, batches0 = ex.stats.items, ex.stats.batches
    kernels.reset_launches()
    TIMES.reset()
    walls, results = [], []
    for _ in range(windows):
        wall, got = load_window(port, reqs, CLIENTS, PER_CLIENT)
        walls.append(wall)
        results.extend(got)
    launches = kernels.launch_counts()
    stages = ex.stats.to_dict()
    for name in CONFIG2_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on this path")
    bad = [r for r in results if (r[2], r[3], r[4]) != (200, "image/jpeg", want[r[0]])]
    if bad:
        raise AssertionError(f"{len(bad)} of {len(results)} answers differ from the "
                             f"off server's (first: {CONFIG2_REQUESTS[bad[0][0]][0]}, "
                             f"status {bad[0][2]})")
    lat = [r[1] for r in results]
    rps = [CLIENTS * PER_CLIENT / wl for wl in walls]
    items, batches = ex.stats.items - items0, ex.stats.batches - batches0
    return {"requests": len(results), "windows": windows, "wall_s": walls,
            "rps_by_window": rps, "rps": statistics.median(rps),
            "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "items": items, "batches": batches, "mean_batch": items / max(1, batches),
            "dispatch_wait_p50_ms": stages["dispatch_wait_p50_ms"],
            "dispatch_wait_p99_ms": stages["dispatch_wait_p99_ms"],
            "launches": launches, "byte_equal_to_off": len(results)}


def wait_for(cond, seconds: float = 10.0) -> bool:
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


def mix_line(label: str, got: dict) -> str:
    return (f"  {label}: req/s by window {', '.join(f'{v:.1f}' for v in got['rps_by_window'])}"
            f" (median {got['rps']:.1f}); p50 {got['p50_ms']:.2f} ms, p99 "
            f"{got['p99_ms']:.2f} ms; {got['items']} items in {got['batches']} batches "
            f"(mean {got['mean_batch']:.2f}); dispatch_wait p50 "
            f"{got['dispatch_wait_p50_ms']:.2f} ms; every answer byte-equal to off")


def lanes_checks(ex, policy: str, got: dict) -> None:
    """Every lane dispatched and the lanes' ledgers came to rest."""
    snap = ex.stats.to_dict()["lanes"]
    if not all(ln["dispatches"] > 0 for ln in snap):
        raise AssertionError(f"{policy}: a lane never dispatched: {snap}")
    if not wait_for(lambda: all(ln.owed == 0 and ln.inflight == 0
                                for ln in ex._lanes.lanes)):
        raise AssertionError(f"{policy}: lane ledgers not at rest")
    got["lanes"] = snap
    got["sharded_batches"] = ex.stats.sharded_batches


def failover(srv, bodies: dict, want: list) -> dict:
    """One window of the mix with device.chip_error[1] armed: lane 1 is
    quarantined, every answer stays byte-equal, the generation rises by 1."""
    from imaginary_tpu_torch import failpoints

    ex = srv.service.executor
    gen0 = ex._mesh_generation
    failpoints.activate("device.chip_error[1]=error")
    try:
        got = serve_mix(srv, bodies, want, windows=1)
    finally:
        failpoints.deactivate()
    lane1 = ex._lanes.lane(1)
    if not wait_for(lambda: not lane1.active):
        raise AssertionError("lane 1 was not quarantined")
    if ex._mesh_generation - gen0 != 1:
        raise AssertionError(f"mesh generation moved by {ex._mesh_generation - gen0}, "
                             f"expected 1")
    got["lanes"] = ex.stats.to_dict()["lanes"]
    got["device_failures"] = ex.stats.device_failures
    got["sharded_mesh"] = list(ex._lane_mesh.shape)
    return got


def mesh_lanes_phase() -> dict:
    """Phase 10(b) and (c), bracketed by the off server under the same mix
    in the same call (off, lanes from the command line, four lanes, sharded,
    off): (b) the server started from the command line with --mesh-policy
    lanes (one lane per visible card), (c) lanes and sharded dispatch over
    LANE_ENTRIES entries of card 0, then device.chip_error[1] with
    breaker_threshold 1 on the sharded server."""
    import json as _json

    import torch

    from imaginary_tpu_torch import cli
    from imaginary_tpu_torch.web.app import make_server

    bodies = {}
    for _, src, _ in CONFIG2_REQUESTS:
        with open(src, "rb") as f:
            bodies[src] = f.read()
    # one host-pool worker per client thread (--cpus): each lane of the
    # four then forms chunks of the sharded threshold, as the thread per
    # connection of the earlier server did; phase 6 measures the default
    off_kw = dict(device=DEVICE, max_batch=CONFIG2_MAX_BATCH, batch_form_ms=CONFIG2_FORM_MS,
                  cpus=CLIENTS)
    out: dict = {}
    box: dict = {}

    def off_run(srv):
        box.setdefault("want", alone_bodies(srv, bodies))
        return serve_mix(srv, bodies, box["want"])

    out["off_before"] = serving(make_server("127.0.0.1", 0, **off_kw), off_run)
    want = box["want"]
    log(mix_line("off (before)", out["off_before"]))

    # (b) the normal entry point
    def cli_run(srv):
        got = serve_mix(srv, bodies, want)
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.server_address[1]}/health",
                                    timeout=60) as r:
            got["health"] = _json.loads(r.read())
        return got

    args = cli.parse_args(["--addr", "127.0.0.1", "--port", "0", "--device", DEVICE,
                           "--mesh-policy", "lanes", "--max-batch", str(CONFIG2_MAX_BATCH),
                           "--batch-form-ms", str(CONFIG2_FORM_MS), "--log-level", "error",
                           "--cpus", str(CLIENTS)])
    got = serving(cli.make_server_from_args(args), cli_run)
    health = got.pop("health")
    ex = health["executor"]
    lanes = ex["lanes"]
    cards = torch.cuda.device_count() if DEVICE == "cuda" else 1
    if (len(lanes) != cards or health["deviceHealth"]["count"] != cards
            or (health["backend"], health["devices"]) != (torch.device(DEVICE).type, cards)):
        raise AssertionError(f"/health shows {len(lanes)} lanes for {cards} cards")
    dispatched = sum(ln["dispatches"] for ln in lanes)
    if dispatched != ex["batches"]:
        raise AssertionError(f"lane dispatches {dispatched} != batches {ex['batches']}")
    got["lanes"] = lanes
    out["cli_lanes"] = got
    log(mix_line(f"--mesh-policy lanes, {cards} card(s), one lane each", got))

    # (c) four lanes on one card: lanes, then sharded dispatch and failover
    entries = [torch.device(DEVICE, 0) if DEVICE == "cuda" else torch.device(DEVICE)]
    entries = entries * LANE_ENTRIES
    for policy in ("lanes", "sharded"):
        def lane_run(srv, policy=policy):
            ex = srv.service.executor
            got = serve_mix(srv, bodies, want)
            lanes_checks(ex, policy, got)
            if policy == "sharded":
                if ex.stats.sharded_batches <= 0:
                    raise AssertionError("no chunk was split over the mesh")
                got["failover"] = failover(srv, bodies, want)
            return got

        got = serving(make_server("127.0.0.1", 0, mesh_policy=policy, devices=entries,
                                  shard_min_items=LANE_SHARD_MIN, breaker_threshold=1,
                                  breaker_cooldown_s=600.0, **off_kw), lane_run)
        out[f"entries4_{policy}"] = got
        log(mix_line(f"{policy} over {LANE_ENTRIES} entries of one card", got)
            + f"; dispatches {[ln['dispatches'] for ln in got['lanes']]}, "
            f"{got['sharded_batches']} chunks split over the mesh")
        if policy == "sharded":
            f = got["failover"]
            log(f"  chip_error[1]: {f['requests']} answers byte-equal to off, "
                f"{f['device_failures']} failed launch(es), lane 1 quarantined, mesh "
                f"generation +1, sharded mesh now {f['sharded_mesh']}; "
                f"{f['rps']:.1f} req/s, p99 {f['p99_ms']:.2f} ms")
    out["off_after"] = serving(make_server("127.0.0.1", 0, **off_kw), off_run)
    log(mix_line("off (after)", out["off_after"]))
    return out


# Phase 10(d): config 3's /pipeline and the dry run's chain on the 4K PNG
# (served as JPEG), and four chains on the same frame as a 4:2:0 JPEG on the
# yuv420 transport; requests of each chain one at a time on each server
SPATIAL_BW_QUERY = {"width": "1920", "sigma": "2", "colorspace": "bw", "type": "jpeg"}
SPATIAL_JPEG_QUALITY = 90
SPATIAL_SERIAL = 2
SPATIAL_PROFILED = 1
# (name, source, path, MIME type, decoded (h, w), plan: (op, query) or
# the /pipeline's ops)
SPATIAL_CROP = {"width": "3000", "height": "2000"}
SPATIAL_SMART = {"width": "2400", "height": "2000"}
SPATIAL_EMBED = {"width": "3000", "height": "2000", "extend": "white"}
SPATIAL_REQUESTS = (
    ("config3", "png", "/pipeline?operations=" + urllib.parse.quote(json.dumps(CONFIG3_OPS)),
     "image/webp", (720, 1280), CONFIG3_OPS),
    ("bw", "png", "/resize?" + urllib.parse.urlencode(SPATIAL_BW_QUERY), "image/jpeg",
     (1080, 1920), ("resize", SPATIAL_BW_QUERY)),
    ("jpeg-resize", "jpeg", "/resize?width=1920", "image/jpeg", (1080, 1920),
     ("resize", {"width": "1920"})),
    ("jpeg-blur", "jpeg", "/blur?sigma=2", "image/jpeg", (2160, 3840),
     ("blur", {"sigma": "2"})),
    ("jpeg-flip", "jpeg", "/flip", "image/jpeg", (2160, 3840), ("flip", {})),
    ("jpeg-bw", "jpeg", "/resize?" + urllib.parse.urlencode(SPATIAL_BW_QUERY), "image/jpeg",
     (1080, 1920), ("resize", SPATIAL_BW_QUERY)),
    ("jpeg-crop", "jpeg", "/crop?" + urllib.parse.urlencode(SPATIAL_CROP), "image/jpeg",
     (2000, 3000), ("crop", SPATIAL_CROP)),
    ("jpeg-smartcrop", "jpeg", "/smartcrop?" + urllib.parse.urlencode(SPATIAL_SMART),
     "image/jpeg", (2000, 2400), ("smartcrop", SPATIAL_SMART)),
    ("jpeg-rotate", "jpeg", "/rotate?rotate=90", "image/jpeg", (3840, 2160),
     ("rotate", {"rotate": "90"})),
    ("jpeg-flop", "jpeg", "/flop", "image/jpeg", (2160, 3840), ("flop", {})),
    ("jpeg-exif6", "jpeg6", "/resize?width=1920", "image/jpeg", (3413, 1920),
     ("resize", {"width": "1920"})),
    ("jpeg-embed", "jpeg", "/resize?" + urllib.parse.urlencode(SPATIAL_EMBED), "image/jpeg",
     (2000, 3000), ("resize", SPATIAL_EMBED)),
)
# each chain's launches a request on the route over n shards, as the
# kernels each shard launches (n of each W-sharded stage's kernel, no K8
# beside a K3; the smartcrop's K9 three a shard: rows, scan, columns)
SPATIAL_KERNELS = {
    "config3": ("resample", "blur_halo", "composite"),
    "bw": ("resample", "blur_halo", "gray"),
    "jpeg-resize": ("yuv420_unpack", "resample", "yuv420_pack"),
    "jpeg-blur": ("yuv420_unpack", "blur_halo", "yuv420_pack"),
    "jpeg-flip": ("yuv420_unpack", "orient", "yuv420_pack"),
    "jpeg-bw": ("yuv420_unpack", "resample", "blur_halo", "yuv420_pack"),
    "jpeg-crop": ("yuv420_unpack", "resample", "gather", "yuv420_pack"),
    "jpeg-smartcrop": ("yuv420_unpack", "resample", "saliency", "saliency", "saliency",
                       "window_argmax", "gather", "yuv420_pack"),
    "jpeg-rotate": ("yuv420_unpack", "orient", "orient", "yuv420_pack"),
    "jpeg-flop": ("yuv420_unpack", "orient", "yuv420_pack"),
    "jpeg-exif6": ("yuv420_unpack", "orient", "orient", "resample", "yuv420_pack"),
    "jpeg-embed": ("yuv420_unpack", "resample", "gather", "yuv420_pack"),
}
# The dct transport's chains (--transport-dct --transport-dct-egress), on
# servers of their own: the 4K frame as a 4:2:0 JPEG at /resize, /crop,
# /rotate and /smartcrop, as 4:2:2, 4:4:4 and gray JPEGs at /resize (K11
# at k = 8 in every layout), scaled to 8000x6000 at /resize?width=3000
# (shrink 2: K11 at k = 4), and one 4:2:0 /resize whose progressive
# output keeps the pixel readback (egress off: K11 -> K1 -> K3)
SPATIAL_DCT_SOURCES = {"jpeg": ("420", None), "jpeg422": ("422", None),
                       "jpeg444": ("444", None), "jpeggray": ("gray", None),
                       "jpeg48mp": ("420", (8000, 6000))}
SPATIAL_DCT_REQUESTS = (
    ("dct-resize", "jpeg", "/resize?width=1920", "image/jpeg", (1080, 1920),
     ("resize", {"width": "1920"})),
    ("dct-crop", "jpeg", "/crop?" + urllib.parse.urlencode(SPATIAL_CROP), "image/jpeg",
     (2000, 3000), ("crop", SPATIAL_CROP)),
    ("dct-rotate", "jpeg", "/rotate?rotate=90", "image/jpeg", (3840, 2160),
     ("rotate", {"rotate": "90"})),
    ("dct-smartcrop", "jpeg", "/smartcrop?" + urllib.parse.urlencode(SPATIAL_SMART),
     "image/jpeg", (2000, 2400), ("smartcrop", SPATIAL_SMART)),
    ("dct422-resize", "jpeg422", "/resize?width=1920", "image/jpeg", (1080, 1920),
     ("resize", {"width": "1920"})),
    ("dct444-resize", "jpeg444", "/resize?width=1920", "image/jpeg", (1080, 1920),
     ("resize", {"width": "1920"})),
    ("dctgray-resize", "jpeggray", "/resize?width=1920", "image/jpeg", (1080, 1920),
     ("resize", {"width": "1920"})),
    ("dct48mp-resize", "jpeg48mp", "/resize?width=3000", "image/jpeg", (2250, 3000),
     ("resize", {"width": "3000"})),
    ("dct-resize-yuv", "jpeg", "/resize?width=1920&interlace=true", "image/jpeg",
     (1080, 1920), ("resize", {"width": "1920", "interlace": "true"})),
)
SPATIAL_DCT_MAX_MP = 50.0  # the dct servers' --max-allowed-resolution (megapixels)
_DCT_RESIZE = ("from_dct", "resample", "to_dct")
SPATIAL_KERNELS.update({
    "dct-resize": _DCT_RESIZE,
    "dct-crop": ("from_dct", "resample", "gather", "to_dct"),
    "dct-rotate": ("from_dct", "orient", "orient", "to_dct"),
    "dct-smartcrop": ("from_dct", "resample", "saliency", "saliency", "saliency",
                      "window_argmax", "gather", "to_dct"),
    "dct422-resize": _DCT_RESIZE, "dct444-resize": _DCT_RESIZE,
    "dctgray-resize": _DCT_RESIZE, "dct48mp-resize": _DCT_RESIZE,
    "dct-resize-yuv": ("from_dct", "resample", "yuv420_pack"),
})
SPATIAL_EXIF = 6  # the orientation of the jpeg6 source
# a plan with a bucket shrink (K4) on the route: large.jpg's /blur, whose
# 1920 columns sit in a 2048-wide bucket, shrunk to 1920 before K3
SPATIAL_SHRINK_PLAN = ("blur", {"sigma": "2"})


def make_4k_jpeg(png: bytes, orientation=None, layout: str = "420", size=None,
                 **save) -> bytes:
    """The phase's 4K PNG as a JPEG (Pillow) of the layout ("420", "422",
    "444" or "gray"), with an EXIF orientation when one is given, scaled
    to size = (w, h) when one is given; `save` goes to Pillow's encoder
    (restart_marker_rows=1 puts a restart marker after every MCU row)."""
    import io

    from PIL import Image

    out = io.BytesIO()
    kw = dict(save)
    if orientation is not None:
        exif = Image.Exif()
        exif[0x0112] = orientation
        kw["exif"] = exif.tobytes()
    im = Image.open(io.BytesIO(png)).convert("RGB")
    if size is not None:
        im = im.resize(size, Image.BILINEAR)
    if layout == "gray":
        im.convert("L").save(out, "JPEG", quality=SPATIAL_JPEG_QUALITY, **kw)
    else:
        im.save(out, "JPEG", quality=SPATIAL_JPEG_QUALITY,
                subsampling={"444": 0, "422": 1, "420": 2}[layout], **kw)
    return out.getvalue()


def spatial_plans(srcs: dict, dct: bool = False) -> dict:
    """name -> (input array, plan) of each SPATIAL_REQUESTS chain, or with
    `dct` of each SPATIAL_DCT_REQUESTS chain as the dct transport plans it
    (the egress off for a progressive output); srcs maps each source name
    to its bytes."""
    out = {}
    for name, src, _, _, _, plan in SPATIAL_DCT_REQUESTS if dct else SPATIAL_REQUESTS:
        if dct:
            op, query = plan
            wrapped, packed, _ = dct_request_plan(srcs[src], op, query,
                                                  query.get("interlace") != "true")
            out[name] = (packed, wrapped)
        elif src == "png" and isinstance(plan, list):
            out[name] = pipeline_request(srcs[src], plan, "rgb")
        else:
            out[name] = request_plan(srcs[src], *plan)
    return out


def spatial_expected(plan, arr, n: int) -> dict:
    """One request's launches on the spatial route over n shards: n of
    each W-sharded stage's kernels, one of each stage after a gather; a
    GraySpec right before a ToYuv420Spec on the same side of the gather
    launches nothing (its K3 applies the luma), and after the gather a run
    of orientation stages is one K5. Worked out here from the specs apart
    from the runner's `launch_steps` and `orient_runs`."""
    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.ops import chain
    from imaginary_tpu_torch.ops.buckets import bucket_shape

    specs = plan.spec_key()
    hb, wb = plan.in_bucket if plan.in_bucket is not None else bucket_shape(*arr.shape[:2])
    sharded, gather_at = chain.spatial_split(specs, hb, wb, n)
    live = chain.live_stages(specs, hb, wb)
    names = [type(specs[i]).__name__ for i in live]
    out = dict.fromkeys(kernels.LAUNCHES, 0)
    for k, i in enumerate(live):
        if (names[k] == "GraySpec" and k + 1 < len(live) and names[k + 1] == "ToYuv420Spec"
                and (i in sharded) == (live[k + 1] in sharded)):
            continue
        if (k and i not in sharded and live[k - 1] not in sharded
                and names[k] in ORIENT_SPECS and names[k - 1] in ORIENT_SPECS):
            continue  # the gathered tail folds an orientation run into one K5
        per = SHARD_LAUNCHES.get(names[k], SPEC_LAUNCHES[names[k]]) if i in sharded \
            else SPEC_LAUNCHES[names[k]]
        for kname, v in per.items():
            out[kname] += v * (n if i in sharded else 1)
    return out


# a shard's launches of a W-shard form where they differ from the whole
# stage's (SPEC_LAUNCHES): K13 in place of K6; K9's row pass, its scan and
# its columns
SHARD_LAUNCHES = {"BlurSpec": {"blur_halo": 1},
                  "SmartExtractSpec": {"saliency": 3, "window_argmax": 1, "gather": 1}}
# each W-shard form's kernel (launch_spatial's trace names the spec, or a
# stages.ShardLaunch whose fn is counted as kernels._COUNT_AS says)
SHARD_KERNELS = {"SampleSpec": "resample", "BlurSpec": "blur_halo",
                 "CompositeSpec": "composite", "GraySpec": "gray",
                 "FromYuv420Spec": "yuv420_unpack", "ToYuv420Spec": "yuv420_pack",
                 "ShrinkBucketSpec": "gather", "ExtractSpec": "gather",
                 "EmbedSpec": "gather", "FlipSpec": "orient", "FlopSpec": "orient",
                 "TransposeSpec": "orient", "FromDctSpec": "from_dct", "ToDctSpec": "to_dct"}


def shard_kernel(spec) -> str:
    """The kernel a trace entry's spec launches (a ShardLaunch's fn counts
    under the kernel `kernels._COUNT_AS` names)."""
    from imaginary_tpu_torch import kernels

    name = type(spec).__name__
    return kernels._COUNT_AS[spec.fn] if name == "ShardLaunch" else SHARD_KERNELS[name]


def check_shard(spec, args, out, res, case) -> None:
    """A trace entry's launch against its plain version on its own
    arguments: K9's outputs relative (II_RTOL: another expf), K10's keys
    exact, K12's coefficients by `check_coef`, the rest F32_TOL (U8_TOL
    where it writes uint8)."""
    import torch

    from imaginary_tpu_torch.kernels import reference

    kname = shard_kernel(spec)
    plain = spec.apply_shard(*args, impl=reference)[0]
    pairs = list(zip(out, plain)) if isinstance(out, tuple) else [(out, plain)]
    if kname == "saliency" and spec.fn == "saliency_rows_shard":
        for k, (got, want) in enumerate(pairs):
            d = (got.double() - want.double()).abs()
            lim = SAL_MAP_ATOL + SAL_MAP_RTOL * want.double().abs()
            if not bool((d <= lim).all()):
                raise AssertionError(f"{kname} [{case}-{k}]: max |err| {float(d.max())} "
                                     f"over {SAL_MAP_RTOL} |want| + {SAL_MAP_ATOL}")
            res.setdefault(kname, {})[f"{case}-{k}" if k else case] = {
                "max_abs_err": float(d.max())}
    elif kname == "saliency":
        check_rel(kname, out, plain, res, case, II_RTOL)
    elif kname == "window_argmax":
        if not torch.equal(out, plain):
            raise AssertionError(f"{kname} [{case}]: keys differ from the plain version's")
        res.setdefault(kname, {})[case] = {"max_abs_err": 0.0}
    elif kname == "to_dct":
        check_coef(kname, out, plain, res, case)
    else:
        u8 = pairs[0][0].dtype == torch.uint8
        check_all(kname, pairs, res, case, U8_TOL if u8 else F32_TOL)


def first_tensor(out):
    """A trace entry's output, or the first of its outputs."""
    return out[0] if isinstance(out, tuple) else out


def same_output(a, b) -> bool:
    """Two fetched outputs (arrays, or YuvPlanes) equal bit for bit."""
    import numpy as np

    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    return all(np.array_equal(getattr(a, k), getattr(b, k)) for k in ("y", "u", "v"))


def shard_timing(res, name: str, case: str, launches: list, whole, nbytes: int,
                 flops: float, whole_name: str) -> dict:
    """Time `launches` ((spec, apply_shard args) of one stage's shards, one
    after another on the current stream) beside `whole`, the unsharded
    kernel on the same columns, and their plain versions; the row goes to
    res[name][case] beside the shards' largest error."""
    from imaginary_tpu_torch.kernels import reference

    def shards(impl=None):
        return [sp.apply_shard(*a, impl=impl) if impl else sp.apply_shard(*a)
                for sp, a in launches]

    ms = device_ms(shards)
    plain = device_ms(lambda: shards(reference), calls=3, reps=3)
    whole_ms = device_ms(whole)
    b, by = bound_ms(nbytes, flops)
    prefix = case + "-stage"
    res[name][case] = {
        "max_abs_err": max(v["max_abs_err"] for k, v in res[name].items()
                           if k.startswith(prefix)),
        "ms": ms, "plain_ms": plain, whole_name + "_ms": whole_ms,
        "ms_over_whole": ms / whole_ms, "bound_ms": b, "bound_by": by,
        "library_ms": None, "bytes": nbytes, "shards": len(launches),
        "shard_shape": list(launches[0][1][0].shape)}
    log(f"  {name} {case}: {len(launches)} shards of {list(launches[0][1][0].shape)} "
        f"{ms:.4f} ms, {whole_name} on the same columns {whole_ms:.4f} ms "
        f"({ms / whole_ms:.2f}x), plain {plain:.4f} ms, bound {b:.4f} ms ({by})")
    return res[name][case]


# K2's and K3's W-shard forms at the seams of their designs, as (case, h,
# w, bucket hb, bucket wb, shards): an odd width whose last 2x2 block is
# split by the valid edge; the valid chroma edge in a shard's left halo (hi
# 31: shard 2 of [64, 96) is wholly past w = 63) and in its right halo (hi
# 48); a shard wholly past the valid width; a width that the ladder
# buckets to 6144, whose last shard's chroma [2304, 3072) lies past hi =
# 2049; and the valid edge on a seam.
SHARD_SEAM_CASES = (
    ("odd-w", 37, 101, 48, 128, 4),
    ("edge-in-left-halo", 21, 63, 32, 128, 4),
    ("edge-in-right-halo", 20, 97, 32, 128, 4),
    ("past-valid", 21, 130, 32, 192, 4),
    ("w4100", 64, 4100, 64, 6144, 4),
    ("edge-on-seam", 19, 64, 32, 128, 2),
)


def shard_seam_inputs(case: tuple, rng) -> tuple:
    """(packed uint8 [hb + hb/2, wb, 1], rgb f32 [1, hb, wb, 3]) of random
    content, bucket padding included, for a SHARD_SEAM_CASES case."""
    import numpy as np

    _, h, w, hb, wb, _ = case
    packed = rng.integers(0, 256, (hb + hb // 2, wb, 1), dtype=np.uint8)
    rgb = rng.uniform(-8.0, 263.0, (1, hb, wb, 3)).astype(np.float32)
    return packed, rgb


def shard_seams(res: dict, entry) -> None:
    """K2's and K3's W-shard forms on SHARD_SEAM_CASES on the card: every
    shard's output equal to the whole image's kernel at its columns bit for
    bit (K2 padding included; K3 with and without K8's luma, its planes
    placed by `shard_assemble`), and within tolerance of its plain
    version."""
    import numpy as np
    import torch

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.kernels import reference
    from imaginary_tpu_torch.ops.stages import FromYuv420Spec, ToYuv420Spec

    rng = np.random.default_rng(SEED + 13)
    for case in SHARD_SEAM_CASES:
        name, h, w, hb, wb, n = case
        packed, rgb = shard_seam_inputs(case, rng)
        ht = torch.tensor([h], dtype=torch.int32, device=entry)
        wt = torch.tensor([w], dtype=torch.int32, device=entry)
        k2, k3 = FromYuv420Spec(hb, wb), ToYuv420Spec(hb, wb)
        whole = kernels.yuv420_to_rgb(torch.from_numpy(packed)[None].to(entry), ht, wt, hb, wb)
        x3 = torch.from_numpy(rgb).to(entry)
        lw = wb // n
        for j in range(n):
            c0, c1 = j * lw, (j + 1) * lw
            x, left, right, _ = k2.shard_input(packed, c0, c1, w, {})
            args = [torch.from_numpy(np.ascontiguousarray(a))[None].to(entry)
                    for a in (x, left, right)]
            got = kernels.yuv420_to_rgb_shard(*args, ht, wt, hb, lw)
            if not torch.equal(got, whole[:, :, c0:c1]):
                raise AssertionError(f"K2 shard {j} of {name}: not K2's columns")
            check("yuv420_unpack", got,
                  reference.yuv420_to_rgb_shard(*args, ht, wt, hb, lw), res,
                  f"shard-seam-{name}-{j}", F32_TOL)
        for luma in (False, True):
            whole3 = kernels.rgb_to_yuv420(x3, ht, wt, hb, wb, luma)
            parts = []
            for j in range(n):
                xs = x3[:, :, j * lw:(j + 1) * lw].contiguous()
                got = kernels.rgb_to_yuv420_shard(xs, ht, wt, hb, lw, j * lw, luma)
                check("yuv420_pack", got,
                      reference.rgb_to_yuv420_shard(xs, ht, wt, hb, lw, j * lw, luma), res,
                      f"shard-seam-{name}-{j}-luma{int(luma)}", U8_TOL)
                parts.append(got)
            assembled = k3.shard_assemble(torch.stack(parts).cpu())
            if not np.array_equal(assembled, whole3.cpu().numpy()):
                raise AssertionError(f"K3 shards of {name} (luma {luma}): not K3's planes")
        log(f"  K2 and K3 W-shard forms at {name} ({h}x{w} in {hb}x{wb}, {n} shards): "
            f"bit-equal to the whole image's kernels, within tolerance of the plain versions")
    torch.cuda.synchronize()


def spatial_shard_check(plans: dict, res: dict, entry, n: int) -> dict:
    """Phase 10(d)'s kernels at the route's own shapes, before the counted
    run: each plan launched W-sharded over n entries of one card
    (`chain.launch_spatial`) and every shard's launch of every sharded
    stage (K2's packed columns with their chroma halos, K1's window from
    the host or from the window exchange, K13 after the halo exchange, K7
    with its shifted `left`, K8, K4 in every mode, K5's flip, flop and
    transpose, the smartcrop's K9, K10 and keyed K4, K3 with the global
    valid mask and K8's luma folded in) held against its plain version on
    the same inputs (`check_shard`), and the assembled output bit-equal to
    the unsharded chain's. Then config 3's K13 shard launches, the 4K
    JPEG's K2, K3 and K5 flip shard launches, the shrink plan's K4 shard
    launches and the 4K JPEG's window exchange timed, each beside the
    unsharded kernel on the same columns, and the new forms
    (`new_form_timings`)."""
    import numpy as np
    import torch

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.ops import chain
    from imaginary_tpu_torch.parallel import spatial

    shard_seams(res, entry)

    streams = [torch.cuda.Stream(entry) for _ in range(n)] if entry.type == "cuda" else None
    timed = {}  # the traces and launches kept for the timings below
    counts, exchanged = {}, {}
    for name, (arr, p) in plans.items():
        trace = []
        launch = chain.launch_spatial(arr, p, [entry] * n, streams, trace)
        got = chain.fetch_batch(launch, [arr], [p])[0]
        torch.cuda.synchronize()
        if launch.gathered is not None:
            raise AssertionError(f"spatial {name}: gathered at {launch.gathered}")
        want = chain.run_single(arr, p, device=entry)
        if not same_output(got, want):
            raise AssertionError(f"spatial {name}: the W-sharded chain differs from the "
                                 f"unsharded one")
        for i, j, spec, args, out in trace:
            check_shard(spec, args, out, res, f"spatial-{name}-stage{i}-shard{j}")
        stages = sorted({(i, shard_kernel(sp), tuple(first_tensor(o).shape),
                          str(first_tensor(o).dtype)) for i, _, sp, _, o in trace})
        wins = {i: [(k0, k1, [s for s, _, _ in parts]) for k0, k1, parts in v]
                for i, v in launch.windows.items()}
        log(f"  spatial {name}: {len(trace)} shard launches each within tolerance of "
            f"its plain version; stages {stages}; windows {wins}; {launch.exchanged} "
            f"bytes exchanged; output bit-equal to the unsharded chain")
        counts[name] = len(trace)
        exchanged[name] = launch.exchanged
        if name in TIMED_CHAINS:
            timed[name] = (arr, p, trace, launch.windows)
    out = {"shard_launches": counts, "exchanged_bytes": exchanged}

    def stage_launches(name, kname):
        return [(sp, a) for _, _, sp, a, _ in timed[name][2] if shard_kernel(sp) == kname]

    # K13 at config 3's shard shapes: one launch a shard, on one stream
    k13 = stage_launches("config3", "blur_halo")
    sp, a0 = k13[0]
    x_full = torch.cat([a[0] for _, a in k13], dim=2)
    h, w, sigma = a0[3], a0[4], a0[5]["sigma"]
    r, c = sp.radius, x_full.shape[3]
    nbytes = sum(t.numel() * t.element_size() for _, a in k13
                 for t in (a[0], a[1], a[2]) if t is not None)
    nbytes += x_full.numel() * 4  # f32 out
    if not torch.equal(torch.cat([s.apply_shard(*a)[0] for s, a in k13], dim=2),
                       kernels.blur(x_full, h, w, sigma, r)):
        raise AssertionError("config 3's K13 shards are not bit-equal to K6 on their columns")
    row = shard_timing(res, "blur_halo", "spatial-config3", k13,
                       lambda: kernels.blur(x_full, h, w, sigma, r), nbytes,
                       blur_flops(h, w, r, c), "k6")
    row["radius"] = r
    out["k13_config3"] = row
    # K2 at the 4K JPEG's shards (the /resize chain; every 4K JPEG chain
    # starts with it) against K2 on the whole packed frame
    arr, p, trace, windows = timed["jpeg-resize"]
    k2 = stage_launches("jpeg-resize", "yuv420_unpack")
    spec2 = k2[0][0]
    packed = torch.from_numpy(np.array(arr))[None].to(entry)
    h, w = k2[0][1][3], k2[0][1][4]
    whole = kernels.yuv420_to_rgb(packed, h, w, spec2.hb, spec2.wb)
    if not torch.equal(torch.cat([s.apply_shard(*a)[0] for s, a in k2], dim=2), whole):
        raise AssertionError("the 4K JPEG's K2 shards are not bit-equal to K2 on the frame")
    nbytes = sum(t.numel() for _, a in k2 for t in (a[0], a[1], a[2]))
    nbytes += whole.numel() * 4
    out["k2_jpeg"] = shard_timing(
        res, "yuv420_unpack", "spatial-jpeg-resize", k2,
        lambda: kernels.yuv420_to_rgb(packed, h, w, spec2.hb, spec2.wb), nbytes,
        30.0 * spec2.hb * spec2.wb, "k2")
    # K3 at the 4K JPEG's /blur shards and the /resize's 1080p ones, each
    # against K3 on the whole frame of the same columns
    for name in ("jpeg-blur", "jpeg-resize"):
        k3 = stage_launches(name, "yuv420_pack")
        spec3, a0 = k3[0]
        x_full = torch.cat([a[0] for _, a in k3], dim=2)
        h, w = a0[3], a0[4]
        whole = kernels.rgb_to_yuv420(x_full, h, w, spec3.hb, spec3.wb)
        assembled = spec3.shard_assemble(torch.stack([s.apply_shard(*a)[0] for s, a in k3])
                                         .cpu())
        if not (assembled == whole.cpu().numpy()).all():
            raise AssertionError(f"{name}'s K3 shards are not bit-equal to K3 on the frame")
        nbytes = x_full.numel() * 4 + whole.numel()
        out["k3_" + name] = shard_timing(
            res, "yuv420_pack", "spatial-" + name, k3,
            lambda x_full=x_full, h=h, w=w, spec3=spec3:
                kernels.rgb_to_yuv420(x_full, h, w, spec3.hb, spec3.wb),
            nbytes, 20.0 * x_full.shape[1] * x_full.shape[2], "k3")
    # K5's flip at the 4K JPEG's shards and K4's bucket shrink at the
    # shrink plan's, each against the kernel on the whole frame of the
    # same columns
    k5 = stage_launches("jpeg-flip", "orient")
    a0 = k5[0][1]
    x_full = torch.cat([a[0] for _, a in k5], dim=2)
    h, w = a0[3], a0[4]
    whole = kernels.orient(x_full, h, w, "flip")
    if not torch.equal(torch.cat([s.apply_shard(*a)[0] for s, a in k5], dim=2), whole):
        raise AssertionError("the 4K JPEG's K5 flip shards are not bit-equal to K5 on the frame")
    out["k5_jpeg-flip"] = shard_timing(
        res, "orient", "spatial-jpeg-flip", k5,
        lambda: kernels.orient(x_full, h, w, "flip"), x_full.numel() * 8, 0.0, "k5")
    k4 = stage_launches("shrink", "gather")
    spec4, a0 = k4[0]
    x_in = torch.cat([a[0] for _, a in k4], dim=2)
    whole = kernels.gather(x_in, spec4.out_hb, spec4.out_wb, mode="window")
    if not torch.equal(torch.cat([s.apply_shard(*a)[0] for s, a in k4], dim=2), whole):
        raise AssertionError("the shrink plan's K4 shards are not bit-equal to K4 on the frame")
    out["k4_shrink"] = shard_timing(
        res, "gather", "spatial-shrink", k4,
        lambda: kernels.gather(x_in, spec4.out_hb, spec4.out_wb, mode="window"),
        2 * whole.numel() * 4, 0.0, "k4")
    # the window exchange ahead of the /resize's K1: each shard's window
    # of K2's output copied from the shards that hold it
    k1_stage = min(windows)
    prev = [o for i, _, _, _, o in trace if i == k1_stage - 1]
    wins = [(k0, k1) for k0, k1, _ in windows[k1_stage]]
    lw = prev[0].shape[2]

    def exchange():
        # every copy on the current stream, so that device_ms times them
        row = []
        for j, x in enumerate(prev):
            sh = spatial.Shard(entry, None, 0, 1, j * lw)
            sh.x = x
            row.append(sh)
        spatial.exchange_window(row, wins)
        return row

    got = exchange()
    for j, (k0, k1) in enumerate(wins):
        torch.cuda.synchronize()
        if not torch.equal(got[j].x, torch.cat(prev, dim=2)[:, :, k0:k1]):
            raise AssertionError(f"exchange_window: shard {j}'s window differs")
    ex_ms = device_ms(exchange)
    per_col = prev[0].shape[1] * prev[0].shape[3] * prev[0].element_size()
    copied = sum(k1 - k0 for k0, k1, parts in windows[k1_stage]) * per_col
    b, by = bound_ms(2 * copied, 0.0)
    out["exchange"] = {"ms": ex_ms, "bytes_copied": copied, "bound_ms": b,
                       "windows": windows[k1_stage], "streams": n}
    log(f"  exchange_window ahead of the 4K JPEG /resize's K1: {copied} bytes copied "
        f"({copied / 1e6:.1f} MB, {n} windows of {[k1 - k0 for k0, k1 in wins]} columns) "
        f"in {ex_ms:.4f} ms, bound {b:.4f} ms (read and write once)")
    out.update(new_form_timings(timed, res, entry, n))
    out.update(dct_form_timings(timed, res, entry))
    torch.cuda.synchronize()
    return out


# the chains whose shard launches spatial_shard_check times
TIMED_CHAINS = ("config3", "jpeg-resize", "jpeg-blur", "jpeg-flip", "shrink", "jpeg-crop",
                "jpeg-embed", "jpeg-flop", "jpeg-rotate", "jpeg-smartcrop", "dct-resize",
                "dct48mp-resize")


def stage_input(trace, stage: int):
    """The whole input of a sharded stage: the stage before's shard
    outputs side by side."""
    import torch

    return torch.cat([o for i, _, _, _, o in trace if i == stage - 1], dim=2)


def exchange_timing(entry, shards: list, col0s: list, exchange, what: str) -> dict:
    """Time `exchange(row)` over shards holding shards[j] at col0s[j]
    (every copy on the current stream, so that device_ms times them)
    against the bound of reading and writing its bytes once."""
    from imaginary_tpu_torch.parallel import spatial

    def run():
        row = []
        for x, c0 in zip(shards, col0s):
            sh = spatial.Shard(entry, None, 0, 1, c0)
            sh.x = x
            row.append(sh)
        tally = [0]
        exchange(row, tally)
        return tally[0]

    copied = run()
    ms = device_ms(run)
    b, by = bound_ms(2 * copied, 0.0)
    log(f"  {what}: {copied} bytes copied ({copied / 1e6:.1f} MB) in {ms:.4f} ms, bound "
        f"{b:.4f} ms (read and write once)")
    return {"ms": ms, "bytes_copied": copied, "bound_ms": b, "bound_by": by}


def new_form_timings(timed: dict, res: dict, entry, n: int) -> dict:
    """The W-shard forms of K4 (extract, embed), K5 (flop, transpose) and
    the smartcrop (K9, K10, K4 from the keys) at the 4K JPEG chains'
    shards, each bit-equal to the unsharded kernel on the same input and
    timed beside it (`shard_timing`); then the transpose's row-band
    exchange and the smartcrop's image window exchange against their
    bounds."""
    import torch

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.kernels import reference
    from imaginary_tpu_torch.ops.stages import FlopSpec, TransposeSpec
    from imaginary_tpu_torch.parallel import spatial

    out = {}

    def stage_of(name, cls=None, fn=None):
        """(stage index, [(spec, args, out)]) of the chain's launches of a
        spec class or of a ShardLaunch fn."""
        got = [(i, sp, a, o) for i, _, sp, a, o in timed[name][2]
               if (cls is not None and isinstance(sp, cls))
               or (fn is not None and getattr(sp, "fn", None) == fn)]
        return got[0][0], [(sp, a, o) for _, sp, a, o in got]

    def whole_of(name, stage, apply):
        """The stage's unsharded kernel on its whole input; the shards'
        outputs side by side must equal it bit for bit."""
        x_full = stage_input(timed[name][2], stage)
        return x_full, (lambda: apply(x_full))

    # K4's extract and embed, K5's flop and transpose: one stage each
    for name, key, cls, kname, label in (
            ("jpeg-crop", "k4_extract", None, "gather", "ExtractSpec"),
            ("jpeg-embed", "k4_embed", None, "gather", "EmbedSpec"),
            ("jpeg-flop", "k5_flop", FlopSpec, "orient", None),
            ("jpeg-rotate", "k5_transpose", TransposeSpec, "orient", None)):
        trace = timed[name][2]
        if cls is None:
            cls = next(type(sp) for _, _, sp, _, _ in trace if type(sp).__name__ == label)
        stage, launches = stage_of(name, cls=cls)
        spec, a0, _ = launches[0]
        h, w, dyn = a0[3], a0[4], a0[5]
        x_full, whole = whole_of(name, stage, lambda x: spec.apply(x, h, w, dyn)[0])
        got = torch.cat([o for _, _, o in launches], dim=2)
        want = whole()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}'s {cls.__name__} shards are not bit-equal to the "
                                 f"kernel on the frame")
        nbytes = 2 * want.numel() * want.element_size()
        out[key] = shard_timing(res, kname, "spatial-" + name,
                                [(sp, a) for sp, a, _ in launches], whole, nbytes, 0.0,
                                kname)
    # the smartcrop: K9's rows and scan, K10, the gather from the keys
    name = "jpeg-smartcrop"
    trace = timed[name][2]
    stage, rows = stage_of(name, fn="saliency_rows_shard")
    _, scans = stage_of(name, fn="saliency_scan_shard")
    _, argmaxes = stage_of(name, fn="window_argmax_shard")
    _, gathers = stage_of(name, fn="gather_shard")
    x_full = stage_input(trace, stage)
    a0 = rows[0][1]
    h, w = a0[3], a0[4]
    a10 = argmaxes[0][1]
    win_h, win_w = a10[3], a10[4]
    ii = kernels.saliency_ii(x_full, h, w)
    if not torch.equal(torch.cat([o for _, _, o in scans], dim=2), ii[:, :, 1:]):
        raise AssertionError("the smartcrop's integral image shards are not K9's on the frame")
    top, left = kernels.window_argmax(ii, h, w, win_h, win_w)
    keys = torch.stack([o for _, _, o in argmaxes], dim=1)
    if [int(v[0]) for v in reference.decode_keys(keys.cpu(), x_full.shape[2])] != \
            [int(top[0]), int(left[0])]:
        raise AssertionError("the smartcrop's shard keys do not decode to K10's window")
    spec = timed[name][1].spec_key()[stage]
    whole_g = kernels.gather(x_full, spec.out_hb, spec.out_wb, top, left, mode="window")
    if not torch.equal(torch.cat([o for _, _, o in gathers], dim=2), whole_g):
        raise AssertionError("the smartcrop's gather shards are not K4's on the frame")
    px = x_full.shape[1] * x_full.shape[2]
    k9_bytes = x_full.numel() * x_full.element_size() + ii.numel() * 4
    out["k9_smartcrop"] = shard_timing(
        res, "saliency", "spatial-" + name, [(sp, a) for sp, a, _ in rows + scans],
        lambda: kernels.saliency_ii(x_full, h, w), k9_bytes, 40.0 * px, "k9")
    # what the shards' candidates read (the same count as the whole
    # image's K10), not the windows exchanged to them
    work = [k10_work(int(h[0]), int(w[0]), int(a[3][0]), int(a[4][0]), a[8], a[9],
                     a[6], a[7]) for _, a, _ in argmaxes]
    out["k10_smartcrop"] = shard_timing(
        res, "window_argmax", "spatial-" + name, [(sp, a) for sp, a, _ in argmaxes],
        lambda: kernels.window_argmax(ii, h, w, win_h, win_w), sum(b for b, _ in work),
        sum(f for _, f in work), "k10")
    out["k10_smartcrop"]["ii_window_bytes"] = sum(a[0].numel() * 4 for _, a, _ in argmaxes)
    out["k4_smartcrop"] = shard_timing(
        res, "gather", "spatial-" + name, [(sp, a) for sp, a, _ in gathers],
        lambda: kernels.gather(x_full, spec.out_hb, spec.out_wb, top, left, mode="window"),
        2 * whole_g.numel() * 4, 0.0, "k4")
    sal_lw = x_full.shape[2] // n
    out["smartcrop_window_exchange"] = exchange_timing(
        entry, [x_full[:, :, j * sal_lw:(j + 1) * sal_lw] for j in range(n)],
        [j * sal_lw for j in range(n)],
        lambda row, tally: spatial.exchange_window(
            row, [(k0, k1) for k0, k1, _ in timed[name][3][stage]], tally),
        "the smartcrop's image window exchange ahead of its K4")
    out["smartcrop_window_exchange"]["columns"] = [k1 - k0 for k0, k1, _ in
                                                   timed[name][3][stage]]
    # the transpose's all-to-all over the rotate's K2 shards
    t_stage, _ = stage_of("jpeg-rotate", cls=TransposeSpec)
    prev = [o for i, _, _, _, o in timed["jpeg-rotate"][2] if i == t_stage - 1]
    lw_prev, band = prev[0].shape[2], prev[0].shape[1] // n
    out["band_exchange"] = exchange_timing(
        entry, prev, [j * lw_prev for j in range(n)],
        lambda row, tally: spatial.exchange_bands(row, band, tally),
        f"the transpose's row-band exchange ({n}x{n} blocks of {band} rows)")
    torch.cuda.synchronize()
    return out


def dct_form_timings(timed: dict, res: dict, entry) -> dict:
    """K11's and K12's W-shard entries at phase 10(d)'s dct chains'
    shards: K11 on the 4K 4:2:0 frame (k = 8, a chroma block of halo each
    side) and on the 48 MP one (k = 4, three planes), K12 on the 4K
    /resize's output; the shards side by side bit-equal to the whole
    kernel on the same input (K12's by `shard_assemble`), and timed
    beside it (`shard_timing`)."""
    import numpy as np
    import torch

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.ops.stages import FromDctSpec, ToDctSpec

    out = {}
    for name in ("dct-resize", "dct48mp-resize"):
        arr, _, trace, _ = timed[name]
        shards = [(sp, a, o) for _, _, sp, a, o in trace if isinstance(sp, FromDctSpec)]
        spec, a0, _ = shards[0]
        x = torch.from_numpy(np.array(arr))[None].to(entry)
        h, w = a0[3], a0[4]

        def whole(x=x, h=h, w=w, spec=spec):
            return kernels.from_dct(x, h, w, spec.hb, spec.wb, spec.k, spec.layout)

        want = whole()
        if not torch.equal(torch.cat([o for _, _, o in shards], dim=2), want):
            raise AssertionError(f"{name}'s K11 shards are not K11 on the frame")
        nbytes = sum(t.numel() * t.element_size() for _, a, _ in shards for t in a[:3]
                     if t is not None) + want.numel() * 4
        # a[6], a[7]: the shard's col0 and lw (`_ShardForm.run_shards`)
        flops = sum(idct_flops(spec.layout, spec.k, spec.hb, a[7]) for _, a, _ in shards)
        out["k11_" + name] = shard_timing(res, "from_dct", "spatial-" + name,
                                          [(sp, a) for sp, a, _ in shards], whole, nbytes,
                                          flops, "k11")
    name = "dct-resize"
    trace = timed[name][2]
    stage = next(i for i, _, sp, _, _ in trace if isinstance(sp, ToDctSpec))
    shards = [(sp, a, o) for i, _, sp, a, o in trace if i == stage]
    spec, a0, _ = shards[0]
    x_full = stage_input(trace, stage)
    h, w, dyn = a0[3], a0[4], a0[5]

    def whole12():
        return kernels.to_dct(x_full, h, w, dyn["qy"], dyn["qc"], spec.hb, spec.wb)

    want = whole12()
    if not np.array_equal(spec.shard_assemble(torch.stack([o for _, _, o in shards]).cpu()),
                          want.cpu().numpy()):
        raise AssertionError(f"{name}'s K12 shards are not K12 on the frame")
    # each window read once, each shard's coefficients written once; per
    # pixel of the MCUs computed ~16 for the colour convert and mean, per
    # coefficient 34 (the FDCT and the quantize)
    nbytes = sum(a[0].numel() * 4 for _, a, _ in shards) + want.numel() * 2
    mcu_cols = sum(-(-(a[6] + a[7]) // 16) * 16 - a[6] // 16 * 16 for _, a, _ in shards)
    flops = (16.0 + 34.0 * 1.5) * spec.hb * mcu_cols
    out["k12_" + name] = shard_timing(res, "to_dct", "spatial-" + name,
                                      [(sp, a) for sp, a, _ in shards], whole12, nbytes,
                                      flops, "k12")
    return out


def spatial_busy(prof, labels: list) -> dict:
    """label -> (busy us, summed us) of the card's activity inside each
    `record_function(label)` window of the client thread in one profiler
    window: each device interval counts for the window its start falls in
    (the requests run one at a time and each ends after its device work)."""
    from torch.autograd import DeviceType

    spans, windows = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
        elif e.name in labels:
            windows.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    out = {}
    for label, wins in windows.items():
        mine = sorted(sp for sp in spans if any(a <= sp[0] < b for a, b in wins))
        busy, end = 0.0, None
        for a, b in mine:
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        out[label] = (busy, sum(b - a for a, b in mine))
    return out


def spatial_route_phase(png: bytes, res: dict) -> dict:
    """Phase 10(d): the SPATIAL_REQUESTS chains (config 3's /pipeline and
    the dry run's bw chain on the 4K PNG; /resize, /blur, /flip, the bw
    chain, /crop, /smartcrop, /rotate, /flop and a filled embed on the
    same frame as a 4:2:0 JPEG, and an EXIF-6 /resize of it), one request
    at a time, from
    the off server, then a lanes server over SPATIAL_SHARDS entries of
    card 0 with --spatial SPATIAL_SHARDS and the default bar (the PNG's
    input bucket 2560x4096 and the JPEG's packed 3840x4096 cross
    3840x2160), then the off server again; then the SPATIAL_DCT_REQUESTS
    chains the same way on three servers with --transport-dct
    --transport-dct-egress --max-allowed-resolution SPATIAL_DCT_MAX_MP (the
    4K frame's coefficients cross the bar at
    every layout, the 48 MP one's at k = 4). Each spatial server's counted
    run (launches reset just before, read just after): every answer
    byte-equal to the off server's, /health's spatial_batches rising by
    the requests served and spatial_gathers empty, each request's
    launches those of `spatial_expected` (n of each sharded stage's
    kernel; no K8 on the JPEG bw chain, folded into its K3; n K11 and n
    K12 a dct request). p50 by server, and the card's busy time a request
    of each chain on each."""
    import collections

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from imaginary_tpu_torch import codecs, kernels
    from imaginary_tpu_torch.ops import chain
    from imaginary_tpu_torch.web.app import make_server

    n = SPATIAL_SHARDS
    t0 = time.perf_counter()
    jpeg = make_4k_jpeg(png)
    log(f"  the 4K frame as a 4:2:0 JPEG: {len(jpeg)} bytes (q {SPATIAL_JPEG_QUALITY}), "
        f"made in {time.perf_counter() - t0:.2f} s")
    srcs = {"png": png, "jpeg": jpeg, "jpeg6": make_4k_jpeg(png, SPATIAL_EXIF)}
    t0 = time.perf_counter()
    for key, (layout, size) in SPATIAL_DCT_SOURCES.items():
        srcs.setdefault(key, make_4k_jpeg(png, layout=layout, size=size))
    log(f"  the dct chains' sources (4:2:2, 4:4:4, gray, 8000x6000 4:2:0): "
        f"{ {k: len(srcs[k]) for k in SPATIAL_DCT_SOURCES} } bytes, made in "
        f"{time.perf_counter() - t0:.2f} s")
    sets = {"pixels": (SPATIAL_REQUESTS, spatial_plans(srcs), {}),
            # the 48 MP source passes the pixel gate (--max-allowed-resolution,
            # 18 MP by default, the reference's)
            "dct": (SPATIAL_DCT_REQUESTS, spatial_plans(srcs, dct=True),
                    {"transport_dct": True, "transport_dct_egress": True,
                     "max_allowed_pixels": SPATIAL_DCT_MAX_MP})}
    per_request = {name: spatial_expected(p, arr, n) for _, plans, _ in sets.values()
                   for name, (arr, p) in plans.items()}
    for name, got in per_request.items():
        want_k = {k: c * n for k, c in collections.Counter(SPATIAL_KERNELS[name]).items()}
        if {k: v for k, v in got.items() if v} != want_k:
            raise AssertionError(f"spatial {name}: the plan launches {got}, not {want_k}")

    def health(port) -> dict:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=60) as r:
            return json.loads(r.read())["executor"]

    def run(srv, requests) -> dict:
        port = srv.server_address[1]
        labels = [f"spatial-request:{name}" for name, *_ in requests]
        for _, src, path, _, _, _ in requests:  # one untimed each
            http(port, path, srcs[src])
        before = health(port)
        kernels.reset_launches()
        lat, bodies = {}, {}
        for name, src, path, mime, dims, _ in requests:
            lat[name], bodies[name] = [], set()
            for _ in range(SPATIAL_SERIAL):
                t0 = time.perf_counter()
                status, ctype, body = http(port, path, srcs[src])
                lat[name].append((time.perf_counter() - t0) * 1e3)
                if (status, ctype) != (200, mime):
                    raise AssertionError(f"spatial phase {name}: {status} {ctype}")
                bodies[name].add(body)
            if codecs.decode(body).array.shape[:2] != dims:
                raise AssertionError(f"spatial phase {name}: output is not {dims}")
        launches = kernels.launch_counts()
        after = health(port)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # a session's first windows may record no device event: two
            # unlabelled requests first
            for _, src, path, *_rest in requests[:2]:
                http(port, path, srcs[src])
            for label, (_, src, path, *_rest) in zip(labels, requests):
                with record_function(label):
                    for _ in range(SPATIAL_PROFILED):
                        http(port, path, srcs[src])
        busy = spatial_busy(prof, labels)
        # a window in which the profiler recorded no device event measured
        # nothing (it happens to a later profiler in one process)
        return {"lat": lat, "bodies": bodies, "launches": launches, "before": before,
                "after": after,
                "busy_us": {label.split(":", 1)[1]: (b / SPATIAL_PROFILED if sm > 0 else None)
                            for label, (b, sm) in busy.items()},
                "summed_us": {label.split(":", 1)[1]: sm / SPATIAL_PROFILED
                              for label, (_, sm) in busy.items()}}

    entry = torch.device(DEVICE, 0) if DEVICE == "cuda" else torch.device(DEVICE)
    check_plans = dict(sets["pixels"][1])
    check_plans.update(sets["dct"][1])
    with open(LARGE_JPG, "rb") as f:
        check_plans["shrink"] = request_plan(f.read(), *SPATIAL_SHRINK_PLAN)
    if "ShrinkBucketSpec" not in {type(s).__name__ for s in check_plans["shrink"][1].spec_key()}:
        raise AssertionError("the shrink plan holds no ShrinkBucketSpec")
    shard_check = spatial_shard_check(check_plans, res, entry, n)

    def servers(key: str) -> dict:
        """The set's requests on the off server, the spatial server, the off
        server again; the spatial server's counted run held to the off
        server's answers and to the plans' launches."""
        requests, plans, kw = sets[key]
        runs = {}
        for side, extra in (("off_before", {}),
                            ("spatial", {"mesh_policy": "lanes", "devices": [entry] * n,
                                         "spatial": n}),
                            ("off_after", {})):
            runs[side] = serving(make_server("127.0.0.1", 0, device=DEVICE, **kw, **extra),
                                 lambda srv: run(srv, requests))
        sp = runs["spatial"]
        for name, *_ in requests:
            want = runs["off_before"]["bodies"][name]
            if len(want) != 1 or runs["off_after"]["bodies"][name] != want:
                raise AssertionError(f"the off server's {name} answers differ among themselves")
            if sp["bodies"][name] != want:
                raise AssertionError(f"spatial {name}: an answer differs from the off server's")
        served = SPATIAL_SERIAL * len(requests)
        rise = sp["after"]["spatial_batches"] - sp["before"]["spatial_batches"]
        if rise != served or sp["after"]["spatial_batches"] != served + len(requests):
            raise AssertionError(f"spatial_batches rose by {rise} for {served} requests "
                                 f"({sp['after']['spatial_batches']} in all)")
        if sp["after"]["spatial_gathers"]:
            raise AssertionError(f"the spatial route gathered: {sp['after']['spatial_gathers']}")
        expected = dict.fromkeys(kernels.LAUNCHES, 0)
        for name, *_ in requests:
            for k, v in per_request[name].items():
                expected[k] += SPATIAL_SERIAL * v
        if sp["launches"] != expected:
            raise AssertionError(f"spatial route launches {sp['launches']}, the plans say "
                                 f"{expected}")
        log(f"  spatial route over {n} entries of one card ({key}): {served} requests "
            f"byte-equal to the off server's, spatial_batches +{rise}, no gather; launches "
            f"{ {k: v for k, v in sp['launches'].items() if v} } ({SPATIAL_SERIAL} of each "
            f"chain: " + "; ".join(f"{name} {'+'.join(SPATIAL_KERNELS[name])} x{n}"
                                  for name, *_ in requests) + ")")
        out = {"launches": sp["launches"], "spatial_batches": sp["after"]["spatial_batches"],
               "spatial_gathers": sp["after"]["spatial_gathers"]}
        for side, r in runs.items():
            out[side] = {"p50_ms": {k: float(np.percentile(v, 50)) for k, v in r["lat"].items()},
                         "lat_ms": r["lat"], "busy_us": r["busy_us"],
                         "summed_us": r["summed_us"]}
            log(f"  {key} {side}: p50 " + ", ".join(f"{k} {v:.2f} ms" for k, v in
                                                   out[side]["p50_ms"].items()))
            log(f"  {key} {side}: card busy a request " + ", ".join(
                f"{k} {'not measured' if v is None else f'{v:.1f} us'}"
                for k, v in r["busy_us"].items()))
        return out

    pixels = servers("pixels")
    dct = servers("dct")
    dct["exchanged_bytes"] = {name: shard_check["exchanged_bytes"][name]
                              for name, *_ in SPATIAL_DCT_REQUESTS}
    # the chain of one config 3 and one 4K JPEG /resize request on the host
    # clock, unsharded and spatial: staging and launch, then the fetch
    # (median of 5 each)
    streams = [torch.cuda.Stream(entry) for _ in range(n)] if DEVICE == "cuda" else None

    def split(launch, arr, p) -> dict:
        ts = []
        for _ in range(6):
            t0 = time.perf_counter()
            y = launch()
            t1 = time.perf_counter()
            chain.fetch_batch(y, [arr], [p])
            ts.append((t1 - t0, time.perf_counter() - t1))
        ts = ts[1:]
        return {"launch_ms": statistics.median(a for a, _ in ts) * 1e3,
                "fetch_ms": statistics.median(b for _, b in ts) * 1e3}

    host = {}
    for name in ("config3", "jpeg-resize"):
        arr, p = sets["pixels"][1][name]
        host[name] = {
            "unsharded": split(lambda: chain.launch_batch([arr], [p], device=entry), arr, p),
            "spatial": split(lambda: chain.launch_spatial(arr, p, [entry] * n, streams),
                             arr, p)}
    out = dict(pixels, shards=n, serial=SPATIAL_SERIAL, per_request=per_request,
               chain_host_ms=host, shard_check=shard_check, jpeg_bytes=len(jpeg), dct=dct)
    for name, sides in host.items():
        log(f"  {name}'s chain on the host clock (median of 5): " + "; ".join(
            f"{k} launch {v['launch_ms']:.2f} ms + fetch {v['fetch_ms']:.2f} ms"
            for k, v in sides.items()))
    torch.cuda.synchronize()
    return out


# --- phase 11: the HTTP layer on the card ------------------------------------

HTTP_KEY = "chip-smoke-key"
HTTP_PREFIX = "/img"
HTTP_SERIAL = 5
# the throttle's rate and burst; requests of the counted run are paced
# under the rate, and a burst of BURST_REQUESTS at once must pass the burst
HTTP_RATE, HTTP_BURST = 20, 5
BURST_REQUESTS = 16
CONFIG1_GET = "/resize?width=300&height=200&file=large.jpg"
EXECUTOR_SPANS = ("batch_form", "dispatch_wait", "drain")


def http_get(port: int, path: str, headers=None, method: str = "GET", body=None):
    """(status, headers, body) of one request, whatever its status."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def http_layer_phase() -> dict:
    """Phase 11 (see the module docstring): config 1 through the
    command line's server with the HTTP layer's options on, its headers,
    /info, /metrics, a placeholder made on the card, and the throttle."""
    import re

    import torch

    from imaginary_tpu_torch import cli, codecs, kernels

    args = cli.parse_args([
        "--addr", "127.0.0.1", "--port", "0", "--device", DEVICE,
        "--key", HTTP_KEY, "--path-prefix", HTTP_PREFIX,
        "--mount", os.path.join(ROOT, "tests", "testdata"),
        "--enable-placeholder", "--return-size", "--http-cache-ttl", "60",
        "--concurrency", str(HTTP_RATE), "--burst", str(HTTP_BURST),
        "--log-level", "error"])
    key = {"API-Key": HTTP_KEY}
    pace = 2.0 / HTTP_RATE  # half the throttle's rate

    def run(srv):
        port = srv.server_address[1]
        out: dict = {}
        # one untimed request first (the first CUDA use of this process's
        # server loads nothing new, but the route's buckets warm)
        status, _, _ = http_get(port, HTTP_PREFIX + CONFIG1_GET, key)
        if status != 200:
            raise AssertionError(f"config 1 through the HTTP layer: {status}")
        time.sleep(pace)
        kernels.reset_launches()
        answers, lat = [], []
        for i in range(HTTP_SERIAL):
            t0 = time.perf_counter()
            got = http_get(port, HTTP_PREFIX + CONFIG1_GET,
                           {**key, "X-Request-ID": f"chip-smoke-{i}"})
            lat.append((time.perf_counter() - t0) * 1e3)
            answers.append((i, got))
            time.sleep(pace)
        out["launches"] = kernels.launch_counts()
        out["latency_ms"] = lat
        for i, (status, hdrs, body) in answers:
            names = [p.split(";")[0] for p in hdrs.get("Server-Timing", "").split(", ")]
            checks = {
                "status": (status, hdrs.get("Content-Type")) == (200, "image/jpeg"),
                "dims": codecs.decode(body).array.shape[:2] == (200, 300),
                "request id": hdrs.get("X-Request-ID") == f"chip-smoke-{i}",
                "server": hdrs.get("Server", "").startswith("imaginary-tpu"),
                "backend": hdrs.get("X-Imaginary-Backend") == "device",
                "return size": (hdrs.get("Image-Width"), hdrs.get("Image-Height"))
                == ("300", "200"),
                "cache": hdrs.get("Cache-Control")
                == "public, s-maxage=60, max-age=60, no-transform",
                "server timing": all(n in names for n in EXECUTOR_SPANS + ("execute",)),
            }
            bad = [k for k, ok in checks.items() if not ok]
            if bad:
                raise AssertionError(f"config 1 answer {i}: {bad} ({status}, {hdrs})")
        out["server_timing"] = answers[-1][1][1]["Server-Timing"]
        status, hdrs, body = http_get(port, HTTP_PREFIX + "/info?file=large.jpg", key)
        info = json.loads(body) if status == 200 else {}
        if (info.get("width"), info.get("height"), info.get("type")) != (1920, 1080, "jpeg"):
            raise AssertionError(f"/info answered {status} {body[:200]!r}")
        time.sleep(pace)
        status, _, body = http_get(port, HTTP_PREFIX + "/metrics", key)
        m = re.search(r'^imaginary_tpu_requests_total\{route="%s/resize",code="2xx"\} (\d+)$'
                      % HTTP_PREFIX, body.decode(), re.M)
        counted = int(m.group(1)) if m else -1
        if status != 200 or counted != HTTP_SERIAL + 1:
            raise AssertionError(f"/metrics counted {counted} /resize answers, "
                                 f"not {HTTP_SERIAL + 1}")
        out["metrics_resize_2xx"] = counted
        time.sleep(pace)
        # a failing request: its placeholder is resized on the card
        kernels.reset_launches()
        status, hdrs, body = http_get(port, HTTP_PREFIX + "/resize?width=300&height=200",
                                      {**key, "Content-Type": "image/jpeg"}, "POST",
                                      b"these bytes are no image")
        ph_launches = kernels.launch_counts()
        if (status, hdrs.get("Content-Type")) != (406, "image/jpeg") or "Error" not in hdrs:
            raise AssertionError(f"placeholder: {status} {hdrs}")
        if codecs.decode(body).array.shape[:2] != (200, 300):
            raise AssertionError("the placeholder is not 300x200")
        on_card = {k: v for k, v in ph_launches.items() if v}
        if not all(ph_launches[k] >= 1 for k in ("yuv420_unpack", "resample", "yuv420_pack")):
            raise AssertionError(f"the placeholder was not made on the card: {ph_launches}")
        out["placeholder_launches"] = on_card
        time.sleep(pace)
        # after the placeholder check: this error's placeholder (the same
        # shape) comes from the service's placeholder cache
        status, _, _ = http_get(port, HTTP_PREFIX + CONFIG1_GET)
        if status != 401:
            raise AssertionError(f"a request without the key answered {status}")
        time.sleep(1.0)  # the throttle's burst refills
        # a burst at once past the throttle's burst
        got: list = [None] * BURST_REQUESTS
        start = threading.Barrier(BURST_REQUESTS)

        def one(i):
            start.wait()
            got[i] = http_get(port, HTTP_PREFIX + CONFIG1_GET, key)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(BURST_REQUESTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        codes = sorted(g[0] for g in got)
        limited = [g for g in got if g[0] == 429]
        if not limited or any("Retry-After" not in g[1] for g in limited):
            raise AssertionError(f"a burst of {BURST_REQUESTS} past the throttle: {codes}")
        if set(codes) - {200, 429}:
            raise AssertionError(f"the burst answered {codes}")
        out["burst_codes"] = {c: codes.count(c) for c in sorted(set(codes))}
        return out

    out = serving(cli.make_server_from_args(args), run)
    want = {k: (HTTP_SERIAL if k in CONFIG1_KERNELS else 0) for k in out["launches"]}
    if out["launches"] != want:
        raise AssertionError(f"config 1's {HTTP_SERIAL} requests through the HTTP layer "
                             f"launched {out['launches']}, not {want}")
    lat = out["latency_ms"]
    log(f"  config 1 through --key, --path-prefix {HTTP_PREFIX}, --return-size, "
        f"--http-cache-ttl 60, --concurrency {HTTP_RATE} --burst {HTTP_BURST}: "
        f"{HTTP_SERIAL} answers, {', '.join(f'{t:.2f}' for t in lat)} ms; launches "
        f"{ {k: v for k, v in out['launches'].items() if v} }")
    log(f"  Server-Timing: {out['server_timing']}")
    log(f"  401 without the key; /info 1920x1080 jpeg; /metrics counted "
        f"{out['metrics_resize_2xx']} /resize answers")
    log(f"  placeholder (406, 300x200 JPEG) made on the card: {out['placeholder_launches']}")
    log(f"  burst of {BURST_REQUESTS} at once: {out['burst_codes']}")
    torch.cuda.synchronize()
    return out


# --- phase 12: URL sources and watermarkImage on the card --------------------

URL_CAP = 16_000_000  # --max-allowed-size: above phase 7's 13.3 MB 4K PNG
URL_RETRIES = 2
URL_PROFILED = 3  # profiled requests of (a), each source in turns
URL_FORWARD = "X-Chip-Smoke"
URL_AUTH = "Bearer chip-smoke"
URL_PIPELINE_OPS = [{"operation": "resize", "params": {"width": 1280}},
                    {"operation": "watermarkImage",
                     "params": {"image": "{origin}/mark.png", "top": 10, "left": 10}}]
URL_STREAM_PATH = "/resize?width=300&type=jpeg"
# the hand-written kernels by their device function names
DEVICE_KERNELS = {"yuv420_to_rgb": "yuv420_unpack", "resample_tiles": "resample",
                  "gather_rows": "gather", "rgb_to_yuv420": "yuv420_pack",
                  "composite": "composite"}


def make_mark() -> bytes:
    """A seeded 240x96 RGBA PNG whose alpha ramps from 0 to 255 across it."""
    import io

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(SEED + 12)
    h, w = MARK_DIMS
    rgb = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    alpha = np.tile(np.linspace(0, 255, w).astype(np.uint8), (h, 1))[..., None]
    out = io.BytesIO()
    Image.fromarray(np.concatenate([rgb, alpha], axis=2), "RGBA").save(out, "PNG")
    return out.getvalue()


class Origin:
    """A local aiohttp origin on 127.0.0.1, on an event loop of its own
    thread: `bodies` by path, a 404 elsewhere, /flaky.jpg answering 503
    with Retry-After: 0 to its first GET and large.jpg after, and
    /big.jpg one byte over URL_CAP. It counts GETs and HEADs by path and
    keeps each GET's headers."""

    def __init__(self, bodies: dict):
        import asyncio

        from aiohttp import web

        self.bodies = bodies
        self.counts: dict = {}
        self.seen: list = []
        self._lock = threading.Lock()
        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", self._handle)
        self._loop = asyncio.new_event_loop()
        ready = threading.Event()
        box: dict = {}

        def run():
            asyncio.set_event_loop(self._loop)
            runner = web.AppRunner(app, access_log=None, handle_signals=False)
            self._loop.run_until_complete(runner.setup())
            self._loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", 0).start())
            box["port"] = runner.addresses[0][1]
            ready.set()
            self._loop.run_forever()
            self._loop.run_until_complete(runner.cleanup())
            self._loop.close()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if not ready.wait(60):
            raise AssertionError("the local origin did not start")
        self.url = f"http://127.0.0.1:{box['port']}"
        self.port = box["port"]

    async def _handle(self, request):
        from aiohttp import web

        path = request.path
        with self._lock:
            c = self.counts.setdefault(path, {"GET": 0, "HEAD": 0})
            c[request.method] = c.get(request.method, 0) + 1
            gets = c["GET"]
            if request.method == "GET":
                self.seen.append((path, dict(request.headers)))
        if path == "/flaky.jpg":
            if request.method == "GET" and gets == 1:
                return web.Response(status=503, headers={"Retry-After": "0"})
            return web.Response(body=self.bodies["/large.jpg"], content_type="image/jpeg")
        if path == "/big.jpg":
            return web.Response(body=b"\xff\xd8" + bytes(URL_CAP - 1),
                                content_type="image/jpeg")
        if path in self.bodies:
            return web.Response(body=self.bodies[path])
        return web.Response(status=404, text="not here")

    def gets(self, path: str) -> int:
        with self._lock:
            return self.counts.get(path, {}).get("GET", 0)

    def close(self) -> None:
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=30)


def url_server_args(origin: Origin, device: str, mount: bool = False) -> list:
    args = ["--addr", "127.0.0.1", "--port", "0", "--device", device,
            "--enable-url-source", "--allowed-origins", origin.url,
            "--max-allowed-size", str(URL_CAP), "--enable-auth-forwarding",
            "--forward-headers", URL_FORWARD, "--source-retries", str(URL_RETRIES),
            "--log-level", "error"]
    return args + (["--mount", os.path.join(ROOT, "tests", "testdata")] if mount else [])


def profiled_request(fn, want: dict) -> tuple:
    """(hand-written kernel launches by wrapper name, other device kernels,
    card busy us) of one call of fn, from torch.profiler (every kernel
    but copies and fills). A window that recorded fewer kernels than
    `want` sums to is taken again, up to PROFILE_TRIES windows (see
    device_kernels), and the fullest one comes back."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best = None
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = collections.Counter(
            kernel_name(e.name).split("<")[0] for e in prof.events()
            if e.device_type == DeviceType.CUDA and "memcpy" not in e.name.lower()
            and "memset" not in e.name.lower())
        ours = {DEVICE_KERNELS[n]: c for n, c in names.items() if n in DEVICE_KERNELS}
        other = {n: c for n, c in names.items() if n not in DEVICE_KERNELS}
        got = (ours, other, busy_union_us(prof)[0])
        if best is None or sum(ours.values()) > sum(best[0].values()):
            best = got
        if sum(best[0].values()) >= sum(want.values()):
            break
    return best


def marked_runs(buf: bytes, op: str, query: dict, mark) -> list:
    """[(input, plan)] the pipeline runs for `op` on buf with the RGBA
    mark, as the server plans it (on the CPU; each chain's output is its
    plain version's)."""
    from imaginary_tpu_torch import pipeline
    from imaginary_tpu_torch.ops import chain
    from imaginary_tpu_torch.params import build_params_from_query

    seen = []

    def rec(arr, plan):
        seen.append((arr, plan))
        return chain.run_single(arr, plan, device="cpu")

    pipeline.process_operation(op, buf, build_params_from_query(query), device="cpu",
                               runner=rec, watermark_rgba=mark)
    return seen


def stream_runs(port: int, reqs: list) -> dict:
    """The config 5 stream one request at a time, then from
    CONFIG4_CLIENTS clients for one window: p50/p99 and req/s."""
    import numpy as np

    lat = []
    for path, body in reqs:
        t0 = time.perf_counter()
        status, ctype, out = http(port, path, body)
        lat.append((time.perf_counter() - t0) * 1e3)
        if (status, ctype) != (200, "image/jpeg"):
            raise AssertionError(f"config 5 stream {path[:80]}: {status} {ctype}")
    wall, got = load_window(port, reqs, CONFIG4_CLIENTS, CONFIG4_PER_CLIENT)
    bad = [g for g in got if (g[2], g[3]) != (200, "image/jpeg")]
    if bad:
        raise AssertionError(f"{len(bad)} config 5 answers under load failed: {bad[0][2]}")
    load = [g[1] for g in got]
    return {"one_p50_ms": float(np.percentile(lat, 50)),
            "one_p99_ms": float(np.percentile(lat, 99)),
            "load_p50_ms": float(np.percentile(load, 50)),
            "load_p99_ms": float(np.percentile(load, 99)),
            "load_rps": len(got) / wall, "requests": len(lat) + len(got)}


def url_source_phase(png: bytes, stream: list) -> dict:
    """Phase 12 (see the module docstring): config 1 over ?url=, the
    placed K7 behind /watermarkimage and a /pipeline watermarkImage, the
    source's error statuses and forwarded headers, and config 5's stream
    over ?url=."""
    import contextlib
    import re

    import numpy as np
    import torch

    from imaginary_tpu_torch import cli, codecs, kernels
    from imaginary_tpu_torch.ops import chain

    with open(LARGE_JPG, "rb") as f:
        large = f.read()
    mark_png = make_mark()
    mark = codecs.decode(mark_png).array
    bodies = {"/large.jpg": large, "/mark.png": mark_png, "/4k.png": png}
    with open(os.path.join(ROOT, "tests", "testdata", "imaginary.jpg"), "rb") as f:
        bodies["/imaginary.jpg"] = f.read()
    for i, (buf, _, _) in enumerate(stream):
        bodies[f"/c5/{i}"] = buf
    out: dict = {}
    with contextlib.ExitStack() as stack:
        origin = Origin(bodies)
        stack.callback(origin.close)
        o = origin.url
        card = cli.make_server_from_args(cli.parse_args(url_server_args(origin, DEVICE)))
        stack.callback(start(card))
        cpu = cli.make_server_from_args(cli.parse_args(url_server_args(origin, "cpu")))
        stack.callback(start(cpu))
        mounted = cli.make_server_from_args(
            cli.parse_args(url_server_args(origin, DEVICE, mount=True)))
        stack.callback(start(mounted))
        port, cpu_port, mount_port = (srv.server_address[1] for srv in (card, cpu, mounted))
        fwd = {"X-Forward-Authorization": URL_AUTH, URL_FORWARD: "phase-12",
               "X-Request-ID": "chip-smoke-url"}
        url_get = f"/resize?width=300&height=200&url={o}/large.jpg"
        wm_get = (f"/watermarkimage?url={o}/large.jpg&image={o}/mark.png&top={MARK_AT[0]}"
                  f"&left={MARK_AT[1]}&opacity={MARK_OPACITY}")
        ops = json.dumps(URL_PIPELINE_OPS).replace("{origin}", o)
        pipe_get = f"/pipeline?url={o}/4k.png&operations={urllib.parse.quote(ops)}"
        # the plans: config 1's K2 -> K1 -> K4 -> K3, /watermarkimage's
        # K2 -> K7 -> K4 (the bucket shrink to 1088x1920) -> K3, the 4K
        # PNG /pipeline's K1 -> K7, each K7 placed
        runs = {"url": marked_runs(large, "resize", {"width": "300", "height": "200"}, None),
                "watermarkimage": marked_runs(
                    large, "watermarkImage",
                    {"image": "m", "top": str(MARK_AT[0]), "left": str(MARK_AT[1]),
                     "opacity": str(MARK_OPACITY)}, mark),
                "pipeline": marked_runs(png, "pipeline", {"operations": ops}, mark)}
        want = {}
        for name, seen in runs.items():
            if len(seen) != 1:
                raise AssertionError(f"{name}: {len(seen)} chain runs, not 1")
            arr, plan = seen[0]
            want[name] = {k: v for k, v in expected_launches(plan, arr).items() if v}
            k7 = [s.replicate for s in plan.spec_key() if type(s).__name__ == "CompositeSpec"]
            if k7 != ([] if name == "url" else [False]):
                raise AssertionError(f"{name}: the plan's K7 modes are {k7}")
            err = planes_err(chain.run_single(arr, plan, device=DEVICE),
                             chain.run_single(arr, plan, device="cpu"))
            if err > U8_TOL:
                raise AssertionError(f"{name}: the chain's planes cuda vs cpu {err} LSB")
            out.setdefault("planes_lsb", {})[name] = err
        if want["url"] != {k: 1 for k in CONFIG1_KERNELS}:
            raise AssertionError(f"config 1's plan launches {want['url']}")
        if want["watermarkimage"] != {"yuv420_unpack": 1, "composite": 1, "gather": 1,
                                      "yuv420_pack": 1}:
            raise AssertionError(f"/watermarkimage's plan launches {want['watermarkimage']}")

        # one untimed request of each first
        for p_, h_ in ((url_get, fwd), (wm_get, {}), (pipe_get, {})):
            status, _, _ = http_get(port, p_, h_)
            if status != 200:
                raise AssertionError(f"{p_[:60]}: {status}")
        http_get(mount_port, CONFIG1_GET)
        # the counted run: (a), then (b)'s two requests, K7's mode spied
        modes: list = []
        composite = kernels.composite

        def spy(*a, **k):
            modes.append(bool(a[7] if len(a) > 7 else k["replicate"]))
            return composite(*a, **k)

        kernels.composite = spy
        try:
            kernels.reset_launches()
            got = {"url": http_get(port, url_get, fwd), "watermarkimage": http_get(port, wm_get),
                   "pipeline": http_get(port, pipe_get)}
            out["launches"] = kernels.launch_counts()
        finally:
            kernels.composite = composite
        total = {}
        for w in want.values():
            for k, v in w.items():
                total[k] = total.get(k, 0) + v
        if {k: v for k, v in out["launches"].items() if v} != total:
            raise AssertionError(f"phase 12's counted run launched {out['launches']}, "
                                 f"the plans say {total}")
        if modes != [False, False]:
            raise AssertionError(f"K7 launched with replicate {modes}, not placed twice")
        # (a) byte-equal to ?file= on the --mount server
        status, hdrs, body = got["url"]
        f_status, _, f_body = http_get(mount_port, CONFIG1_GET)
        if (status, hdrs.get("Content-Type"), f_status) != (200, "image/jpeg", 200):
            raise AssertionError(f"(a): {status} {hdrs.get('Content-Type')}, ?file= {f_status}")
        if body != f_body:
            raise AssertionError("(a): ?url= answered other bytes than ?file=")
        seen = [h for p_, h in origin.seen if p_ == "/large.jpg"
                and h.get("X-Request-ID") == "chip-smoke-url"]
        if not seen:
            raise AssertionError("the origin saw no GET of the counted ?url= request")
        h = seen[-1]
        hdr_checks = {"authorization": h.get("Authorization") == URL_AUTH,
                      "forwarded": h.get(URL_FORWARD) == "phase-12",
                      "traceparent": bool(re.match(r"^00-[0-9a-f]{32}-[0-9a-f]{16}-[0-9a-f]{2}$",
                                                   h.get("traceparent", "")))}
        if not all(hdr_checks.values()):
            raise AssertionError(f"the origin saw {h}: {hdr_checks}")
        out["origin_headers"] = {k: h.get(k) for k in ("Authorization", URL_FORWARD,
                                                       "traceparent", "X-Request-ID")}
        # the launches of (a) and (b) by torch.profiler, and (a)'s card
        # time beside ?file='s, in turns
        prof: dict = {"url": [], "file": []}
        for _ in range(URL_PROFILED):
            prof["url"].append(profiled_request(lambda: http_get(port, url_get, fwd),
                                                want["url"]))
            prof["file"].append(profiled_request(lambda: http_get(mount_port, CONFIG1_GET),
                                                 want["url"]))
        for name, path in (("watermarkimage", wm_get), ("pipeline", pipe_get)):
            prof[name] = [profiled_request(lambda p_=path: http_get(port, p_), want[name])]
        for name, windows in prof.items():
            w = want["url" if name == "file" else name]
            full = [p_ for p_ in windows if p_[0] == w and not p_[1]]
            if not full:
                raise AssertionError(f"{name}: torch.profiler saw {windows[0][0]} and "
                                     f"{windows[0][1]}, the plan says {w}")
            out.setdefault("profiled", {})[name] = {
                "kernels": full[0][0], "busy_us": [p_[2] for p_ in windows]}
        # (b) against the CPU server
        for name, path in (("watermarkimage", wm_get), ("pipeline", pipe_get)):
            status, hdrs, body = got[name]
            c_status, c_hdrs, c_body = http_get(cpu_port, path)
            ctype = hdrs.get("Content-Type")
            want_ctype = "image/jpeg" if name == "watermarkimage" else "image/png"
            if (status, ctype, c_status, c_hdrs.get("Content-Type")) != (
                    200, want_ctype, 200, want_ctype):
                raise AssertionError(f"(b) {name}: card {status} {ctype}, cpu {c_status}")
            a = codecs.decode(body).array.astype(np.int32)
            b = codecs.decode(c_body).array.astype(np.int32)
            if a.shape != b.shape:
                raise AssertionError(f"(b) {name}: {a.shape} against the CPU's {b.shape}")
            entry = {"dims": a.shape[:2], "max_lsb": int(np.abs(a - b).max()),
                     "bytes_identical": body == c_body}
            if name == "watermarkimage":
                # JPEG answers of planes up to 1 LSB apart: phase 9's rule
                # (coefficients within 1; pixels within 1 LSB in every MCU
                # whose coefficients, and its neighbours', agree)
                entry.update(coefficient_parity(body, c_body, a.shape[:2], margin=1))
            elif entry["max_lsb"] > U8_TOL:
                raise AssertionError(f"(b) {name}: {entry['max_lsb']} LSB from the CPU's")
            out.setdefault("marked", {})[name] = entry
        # (c) the source's error statuses
        errors = (
            (f"/resize?width=300&url={o}/gone.jpg", 502,
             f"error fetching remote http image: origin answered status=404 "
             f"(url={o}/gone.jpg)"),
            ("/resize?width=300&url=not-a-url", 400, "Invalid image URL"),
            (f"/resize?width=300&url=http://localhost:{origin.port}/large.jpg", 400,
             f"not allowed remote URL origin: localhost:{origin.port}/large.jpg"),
            (f"/resize?width=300&url={o}/big.jpg", 413,
             f"content length {URL_CAP + 1} exceeds maximum allowed {URL_CAP} bytes"))
        for path, code, message in errors:
            status, hdrs, body = http_get(port, path)
            msg = json.loads(body).get("message") if status == code else None
            if (status, hdrs.get("Content-Type"), msg) != (code, "application/json", message):
                raise AssertionError(f"{path}: {status} {body[:200]!r}, not {code} {message}")
        status, _, _ = http_get(port, f"/resize?width=300&url={o}/flaky.jpg")
        if (status, origin.gets("/flaky.jpg")) != (200, 2):
            raise AssertionError(f"503 then 200: {status} after "
                                 f"{origin.gets('/flaky.jpg')} GETs, not 200 after 2")
        out["errors"] = {p_: c for p_, c, _ in errors}
        out["retried_gets"] = origin.gets("/flaky.jpg")
        # (d) config 5's stream: ?url= and the same bytes as bodies, in turns
        url_reqs = [(f"{URL_STREAM_PATH}&url={o}/c5/{i}", None) for i in range(len(stream))]
        body_reqs = [(URL_STREAM_PATH, buf) for buf, _, _ in stream]
        out["config5"] = {"url": stream_runs(port, url_reqs),
                          "body": stream_runs(port, body_reqs)}
    a_busy = out["profiled"]
    log(f"  (a) config 1 over ?url=: byte-equal to ?file=; launches "
        f"{a_busy['url']['kernels']} (torch.profiler), card busy us a request "
        f"?url= {', '.join(f'{v:.1f}' for v in a_busy['url']['busy_us'])} / ?file= "
        f"{', '.join(f'{v:.1f}' for v in a_busy['file']['busy_us'])} (in turns)")
    log(f"  origin saw {out['origin_headers']}")
    for name in ("watermarkimage", "pipeline"):
        m = out["marked"][name]
        log(f"  (b) {name}: {m['dims']}, kernels {a_busy[name]['kernels']} (K7 placed), "
            f"card busy {a_busy[name]['busy_us'][0]:.1f} us; against the CPU server "
            f"max {m['max_lsb']} LSB"
            + (f" (coefficients max {m['max_coef_diff']}, {m['differing_share']:.2e} "
               f"differ, {m['mcus_equal_share']:.4f} of the MCUs and their neighbours "
               f"equal, {m['max_lsb_where_equal']} LSB there)"
               if name == "watermarkimage" else "")
            + f"; chain planes cuda vs cpu {out['planes_lsb'][name]} LSB")
    log(f"  (c) {out['errors']}; 503 then 200 after {out['retried_gets']} GETs")
    smi = smi_line()
    for src, r in out["config5"].items():
        log(f"  (d) config 5 stream ({len(stream)} images) as {src}: one at a time p50 "
            f"{r['one_p50_ms']:.2f} ms, p99 {r['one_p99_ms']:.2f} ms; {CONFIG4_CLIENTS} "
            f"clients p50 {r['load_p50_ms']:.2f} ms, p99 {r['load_p99_ms']:.2f} ms, "
            f"{r['load_rps']:.1f} req/s [{smi}]")
    torch.cuda.synchronize()
    return out


# --- phase 13: --prewarm and cold launches, the deadline, the golden matrix --

PREWARM_CLIENTS = 8
PREWARM_PER_CLIENT = 3
PREWARM_BOOT_S = 240  # a server's boot, its prewarm included
TESTDATA = os.path.join(ROOT, "tests", "testdata")
# each _COMMON row's source dims (h, w) -> the committed JPEG of those dims
COMMON_SOURCES = {(1080, 1920): "large.jpg", (740, 550): "imaginary.jpg"}
# the stage the reference's app answers a 200 ms device delay against a
# 150 ms budget with (tests/test_torch_deadline.py holds both apps to it)
DEVICE_DELAY_STAGE = "queue"
DEADLINE_BUDGET_S = 0.15
# the ms of each full (generation 2) collection of this process's heap,
# recorded by gc_pause from main's start on
FULL_GC_MS: list = []


def gc_pause(phase: str, info: dict, _t0=[0.0]) -> None:
    """gc.callbacks entry: the length of each full collection."""
    if info.get("generation") != 2:
        return
    if phase == "start":
        _t0[0] = time.perf_counter()
    else:
        FULL_GC_MS.append((time.perf_counter() - _t0[0]) * 1e3)
GOLDEN_PSNR_DB = 45.0  # tests/test_golden.py's floor


def common_routes() -> list:
    """(path, fixture) of each prewarm `_COMMON` row as a GET on its
    source: /resize?width=300&file=large.jpg and the like."""
    from imaginary_tpu_torch import prewarm

    out = []
    for op, q, dims in prewarm.COMMON_QUERIES:
        name = COMMON_SOURCES[dims]
        out.append((f"/{op}?{urllib.parse.urlencode({**q, 'file': name})}", name))
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ServerProcess:
    """`python -m imaginary_tpu_torch` as a fresh process on 127.0.0.1,
    its output in chip_smoke_out/<name>.out and .err; `boot_s` is the
    time from spawn to its listening line (the prewarm inside it)."""

    def __init__(self, name: str, args: list):
        self.name = name
        self.port = free_port()
        os.makedirs(OUT_DIR, exist_ok=True)
        self.out_path = os.path.join(OUT_DIR, f"{name}.out")
        self.err_path = os.path.join(OUT_DIR, f"{name}.err")
        self._out = open(self.out_path, "w")
        self._err = open(self.err_path, "w")
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "imaginary_tpu_torch", "--addr", "127.0.0.1",
             "--port", str(self.port), "--device", DEVICE, "--log-level", "error",
             "--mount", TESTDATA] + args,
            cwd=ROOT, stdout=self._out, stderr=self._err)
        try:
            if not wait_for(lambda: "listening on" in self.stdout()
                            or self.proc.poll() is not None, PREWARM_BOOT_S):
                raise AssertionError(f"{name}: no listening line in {PREWARM_BOOT_S} s")
            if self.proc.poll() is not None:
                raise AssertionError(f"{name} exited {self.proc.returncode}: "
                                     f"{self.stderr()[-2000:]}")
        except BaseException:
            self.stop()
            raise
        self.boot_s = time.perf_counter() - t0

    def stdout(self) -> str:
        with open(self.out_path) as f:
            return f.read()

    def stderr(self) -> str:
        with open(self.err_path) as f:
            return f.read()

    def health(self) -> dict:
        return json.loads(http_get(self.port, "/health")[2])

    def stop(self) -> None:
        if self.proc.poll() is None:
            try:
                note_host_placements(self.name, self.health())
            except (OSError, ValueError) as e:
                log(f"  {self.name}: /health before stop failed: {e}")
                note_host_placements(self.name, None)
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        self._out.close()
        self._err.close()


def drive_common(srv: ServerProcess, routes: list) -> dict:
    """Every route three times one at a time (the server's first request
    first), then PREWARM_PER_CLIENT rounds in which PREWARM_CLIENTS
    clients send one route at once, so chunks of several B form; each
    answer 200 image/jpeg. Host-clock latencies."""
    from imaginary_tpu_torch import codecs

    def get(path):
        t0 = time.perf_counter()
        status, hdrs, body = http_get(srv.port, path)
        ms = (time.perf_counter() - t0) * 1e3
        if (status, hdrs.get("Content-Type")) != (200, "image/jpeg"):
            raise AssertionError(f"{path}: {status} {body[:200]!r}")
        return ms, body

    first_ms, body = get(routes[0][0])
    codecs.decode(body)
    serial = [get(path)[0] for path, _ in routes for _ in range(3)]
    lat: list = []
    errors: list = []
    lock = threading.Lock()

    # each round, every client sends the same route at once, so its
    # items meet in one chunk
    rounds = threading.Barrier(PREWARM_CLIENTS)

    def client(i):
        try:
            for j in range(PREWARM_PER_CLIENT):
                rounds.wait(timeout=120)
                ms, _ = get(routes[j % len(routes)][0])
                with lock:
                    lat.append(ms)
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)
            rounds.abort()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(PREWARM_CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    ex = srv.health()["executor"]
    return {"first_ms": first_ms, "serial_p50_ms": statistics.median(serial),
            "serial_ms": serial, "concurrent_p50_ms": statistics.median(lat),
            "concurrent_ms": lat, "max_group": ex["max_group"],
            "compile_misses": ex["compile_misses"], "items": ex["items"],
            "batches": ex["batches"]}


PREWARM_LINE = r"prewarmed (\d+) op-chain programs \((\d+) failed\) in ([\d.]+)s"


def prewarm_phase(smi: str) -> dict:
    """Phase 13(a): a fresh server with --prewarm, then a fresh one
    without, on the same requests."""
    import re

    routes = common_routes()
    out: dict = {"routes": [p for p, _ in routes]}
    srv = ServerProcess("prewarm", ["--prewarm"])
    try:
        m = re.search(PREWARM_LINE, srv.stdout())
        if not m:
            raise AssertionError(f"no prewarm line: {srv.stdout()[-1000:]!r}")
        warmed, failed, secs = int(m.group(1)), int(m.group(2)), float(m.group(3))
        if failed or not warmed:
            raise AssertionError(f"prewarm warmed {warmed}, failed {failed}: "
                                 f"{srv.stderr()[-3000:]}")
        health = srv.health()
        out["launches"] = health["kernelLaunches"]
        ex0 = health["executor"]
        if (ex0["compile_misses"], ex0["items"]) != (0, 0):
            raise AssertionError(f"the prewarmed server before any request: {ex0}")
        # (a CPU rehearsal's plain versions count no launch)
        missing = [k for k in CONFIG1_KERNELS if not out["launches"][k]]
        if missing and DEVICE != "cpu":
            raise AssertionError(f"prewarm launched none of {missing}: {out['launches']}")
        out["warm"] = drive_common(srv, routes)
        out["warm"].update(boot_s=srv.boot_s, warmed=warmed, failed=failed,
                           prewarm_s=secs, line=m.group(0))
    finally:
        srv.stop()
    warm = out["warm"]
    if warm["compile_misses"] != 0:
        raise AssertionError(f"the prewarmed server counted {warm['compile_misses']} "
                             "compile misses")
    if warm["max_group"] < 2:
        raise AssertionError(f"no chunk of several B formed: max_group {warm['max_group']}")
    srv = ServerProcess("cold", [])
    try:
        out["cold"] = drive_common(srv, routes)
        out["cold"]["boot_s"] = srv.boot_s
    finally:
        srv.stop()
    cold = out["cold"]
    if cold["compile_misses"] <= 0:
        raise AssertionError("the server without --prewarm counted no compile miss")
    log(f"  prewarm: {warm['line']}; boot {warm['boot_s']:.2f} s to the listening "
        f"line; launches {  {k: v for k, v in out['launches'].items() if v} }")
    for label, got in (("--prewarm", warm), ("cold", cold)):
        log(f"  {label}: first request {got['first_ms']:.2f} ms, serial p50 "
            f"{got['serial_p50_ms']:.2f} ms, {PREWARM_CLIENTS} clients p50 "
            f"{got['concurrent_p50_ms']:.2f} ms, max_group {got['max_group']}, "
            f"compile_misses {got['compile_misses']}, boot {got['boot_s']:.2f} s ({smi})")
    out["dct"] = prewarm_dct(routes)
    return out


def prewarm_dct(routes: list) -> dict:
    """Phase 13(a)'s third server: --prewarm with --transport-dct
    --transport-dct-egress launches K11 and K12 on every DCT chain, and
    each route, one at a time, rides the DCT transport both ways with no
    compile miss."""
    import re

    srv = ServerProcess("prewarm-dct", ["--prewarm", "--transport-dct",
                                        "--transport-dct-egress"])
    try:
        m = re.search(PREWARM_LINE, srv.stdout())
        if not m or int(m.group(2)) or not int(m.group(1)):
            raise AssertionError(f"the DCT prewarm: {srv.stdout()[-500:]!r} "
                                 f"{srv.stderr()[-2000:]}")
        launches = srv.health()["kernelLaunches"]
        if DEVICE != "cpu" and not all(launches[k] for k in DCT_KERNELS):
            raise AssertionError(f"the DCT prewarm launched {launches}")
        for path, _ in routes:
            status, _, body = http_get(srv.port, path)
            if status != 200:
                raise AssertionError(f"{path} over the DCT transport: {status} {body[:200]!r}")
        health = srv.health()
    finally:
        srv.stop()
    ex, dct = health["executor"], health["dctTransport"]
    if ex["compile_misses"] != 0 or dct["served"] != len(routes):
        raise AssertionError(f"the DCT server: compile_misses {ex['compile_misses']}, "
                             f"served {dct['served']} of {len(routes)}")
    log(f"  --prewarm --transport-dct --transport-dct-egress: {m.group(0)}, boot "
        f"{srv.boot_s:.2f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }; {len(routes)} routes over the "
        f"DCT transport, compile_misses 0")
    return {"line": m.group(0), "boot_s": srv.boot_s, "launches": launches,
            "served": dct["served"], "compile_misses": ex["compile_misses"]}


def deadline_phase(smi: str) -> dict:
    """Phase 13(b): --request-timeout 0.15 on the card: the device delay's
    504, the header's 504, the admission 503, then 200 with the owed MB
    back to 0."""
    from imaginary_tpu_torch import failpoints
    from imaginary_tpu_torch.web.app import make_server

    body = open(os.path.join(TESTDATA, "imaginary.jpg"), "rb").read()
    jpeg = {"Content-Type": "image/jpeg"}
    out: dict = {}

    def run(srv):
        port = srv.server_address[1]
        svc = srv.service
        # the route's first launch outside any deadline: in a process whose
        # first CUDA use this is, it creates the context (over a second)
        svc.process("resize", body, {"width": "100"})
        # the server runs inside this script, whose heap holds every earlier
        # phase's objects, and a full collection of it holds the GIL: one
        # inside a request's window stalls the event loop against a 150 ms
        # budget. So collect once here and freeze the survivors, which later
        # collections skip; the log line gives the collection's length
        t0 = time.perf_counter()
        gc.collect()
        out["gc"] = {"objects": len(gc.get_objects()),
                     "collect_ms": (time.perf_counter() - t0) * 1e3,
                     "full_collections": len(FULL_GC_MS),
                     "longest_full_ms": max(FULL_GC_MS, default=0.0)}
        gc.freeze()
        t0 = time.perf_counter()
        status, _, got = http_get(port, "/resize?width=100", jpeg, "POST", body)
        if status != 200:
            raise AssertionError(f"the deadline server's first request: {status} after "
                                 f"{(time.perf_counter() - t0) * 1e3:.1f} ms: {got[:300]!r}")
        cases = (("device", "device.execute=delay(200ms)", {}),
                 ("header", "codec.decode=delay(50ms)", {"X-Request-Timeout": "0.001"}))
        for name, spec, hdrs in cases:
            failpoints.activate(spec)
            t0 = time.perf_counter()
            try:
                status, _, got = http_get(port, "/resize?width=100", {**jpeg, **hdrs},
                                          "POST", body)
            finally:
                failpoints.deactivate()
            ms = (time.perf_counter() - t0) * 1e3
            err = json.loads(got) if status == 504 else {}
            out[name] = {"status": status, "ms": ms, **err}
            if status != 504 or "stage" not in err:
                raise AssertionError(f"{name}: {status} {got[:300]!r}")
        if out["device"]["stage"] != DEVICE_DELAY_STAGE:
            raise AssertionError(f"the device delay's 504 at {out['device']['stage']}, "
                                 f"not the reference's {DEVICE_DELAY_STAGE}")
        # the host pool's backlog past the budget, set as the reference's
        # own test sets it
        with svc._inflight_lock:
            svc._service_ewma_ms, svc._inflight = 10_000.0, svc.pool_workers + 50
        try:
            status, hdrs, got = http_get(port, "/resize?width=100", jpeg, "POST", body)
        finally:
            with svc._inflight_lock:
                svc._service_ewma_ms, svc._inflight = 20.0, 0
        out["shed"] = {"status": status, "retry_after": hdrs.get("Retry-After"),
                       "message": json.loads(got).get("message") if status == 503 else ""}
        if status != 503 or not hdrs.get("Retry-After"):
            raise AssertionError(f"the backlog past the budget answered {status} {hdrs}")
        ex = svc.executor
        if not wait_for(lambda: ex.stats.device_owed_mb == 0.0, 10.0):
            raise AssertionError(f"owed MB left charged: {ex.stats.device_owed_mb}")
        status, _, got = http_get(port, "/resize?width=100", jpeg, "POST", body)
        if status != 200:
            raise AssertionError(f"after the failpoints were cleared: {status} {got[:200]!r}")
        wait_for(lambda: ex.stats.device_owed_mb == 0.0, 10.0)
        out["after"] = {"status": status, "device_owed_mb": ex.stats.device_owed_mb}
        if ex.stats.device_owed_mb != 0.0:
            raise AssertionError(f"owed MB after the 200: {ex.stats.device_owed_mb}")
        return out

    try:
        serving(make_server("127.0.0.1", 0, device=DEVICE,
                            request_timeout_s=DEADLINE_BUDGET_S), run)
    finally:
        gc.unfreeze()
    g = out["gc"]
    log(f"  the script's heap: {g['objects']} objects, a full collection "
        f"{g['collect_ms']:.1f} ms; {g['full_collections']} full collections "
        f"before, the longest {g['longest_full_ms']:.1f} ms (host clock)")
    log(f"  --request-timeout {DEADLINE_BUDGET_S}: device.execute=delay(200ms) -> "
        f"{out['device']['status']} at {out['device']['stage']} in "
        f"{out['device']['ms']:.1f} ms; X-Request-Timeout 0.001 + codec.decode="
        f"delay(50ms) -> {out['header']['status']} at {out['header']['stage']} "
        f"(budget {out['header']['budget_ms']} ms); backlog -> {out['shed']['status']} "
        f"Retry-After {out['shed']['retry_after']}; then {out['after']['status']} "
        f"with device_owed_mb {out['after']['device_owed_mb']} ({smi})")
    return out


def golden_cases() -> tuple:
    """(MATRIX, PIPELINES, SMARTCROP) of tests/gen_goldens.py, loaded from
    its file (a machine may have another top-level `tests` package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_gen_goldens", os.path.join(ROOT, "tests", "gen_goldens.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.MATRIX, mod.PIPELINES, mod.SMARTCROP


def golden_options(kw: dict, **extra):
    """tests/gen_goldens.py's options: the case's fields, each marked
    defined as a query would mark it."""
    from imaginary_tpu_torch.options import ImageOptions

    o = ImageOptions(**extra, **kw)
    for k in kw:
        o.mark_defined(k)
    return o


def golden_pixels(body: bytes):
    import io

    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))


def golden_case(buf: bytes, op: str, kw: dict, device: str):
    """A MATRIX or SMARTCROP case through the port's process_operation,
    PNG out (tests/gen_goldens.py's _run_case)."""
    from imaginary_tpu_torch import pipeline

    out = pipeline.process_operation(op, buf, golden_options(kw, type="png"),
                                     device=device)
    return golden_pixels(out.body)


def golden_pipeline(buf: bytes, ops: list, device: str) -> tuple:
    """A PIPELINES case through the port's process_pipeline: (pixels, the
    combined plan's SampleSpec count)."""
    from imaginary_tpu_torch import pipeline
    from imaginary_tpu_torch.ops.stages import SampleSpec
    from imaginary_tpu_torch.options import ImageOptions
    from imaginary_tpu_torch.params import parse_json_operations

    o = ImageOptions(operations=parse_json_operations(json.dumps(ops)))
    plan, *_ = pipeline._build_pipeline_plan(o, 740, 550, 0, 3, None)
    samples = sum(isinstance(st.spec, SampleSpec) for st in plan.stages)
    o = ImageOptions(operations=parse_json_operations(json.dumps(ops)))
    return golden_pixels(pipeline.process_pipeline(buf, o, device=device).body), samples


def golden_window(buf: bytes, kw: dict, device: str) -> tuple:
    """The smartcrop case's pixels and the window K10 chose, read off the
    window_argmax wrapper: {top, left, new_h, new_w}."""
    from imaginary_tpu_torch import kernels

    seen = []
    real = kernels.window_argmax

    def spy(ii, h, w, win_h, win_w):
        top, left = real(ii, h, w, win_h, win_w)
        seen.append({"top": int(top[0]), "left": int(left[0]),
                     "new_h": int(win_h[0]), "new_w": int(win_w[0])})
        return top, left

    kernels.window_argmax = spy
    try:
        arr = golden_case(buf, "smartcrop", kw, device)
    finally:
        kernels.window_argmax = real
    if len(seen) != 1:
        raise AssertionError(f"smartcrop chose {len(seen)} windows")
    return arr, seen[0]


def golden_grade(name: str, arr, want_wh: tuple) -> float:
    """Exact dims and PSNR >= GOLDEN_PSNR_DB against the committed golden;
    returns the PSNR."""
    import numpy as np

    with open(os.path.join(ROOT, "tests", "goldens", f"{name}.png"), "rb") as f:
        gold = golden_pixels(f.read())
    if (arr.shape[1], arr.shape[0]) != tuple(want_wh) or arr.shape != gold.shape:
        raise AssertionError(f"golden {name}: {arr.shape[1]}x{arr.shape[0]}, "
                             f"want {want_wh}")
    mse = float(np.mean((arr.astype(np.float64) - gold.astype(np.float64)) ** 2))
    db = float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)
    if db < GOLDEN_PSNR_DB:
        raise AssertionError(f"golden {name}: PSNR {db:.2f} dB < {GOLDEN_PSNR_DB}")
    return db


def golden_phase() -> dict:
    """Phase 13(c): every golden case of tests/gen_goldens.py through the
    port on the card."""
    import torch

    from imaginary_tpu_torch import kernels

    MATRIX, PIPELINES, SMARTCROP = golden_cases()

    def fixture(name):
        with open(os.path.join(TESTDATA, name), "rb") as f:
            return f.read()

    jpg, smart = fixture("imaginary.jpg"), fixture("smart-crop.jpg")
    out: dict = {"psnr_db": {}}
    kernels.reset_launches()
    for name, op, kw, want in MATRIX:
        out["psnr_db"][name] = golden_grade(name, golden_case(jpg, op, kw, DEVICE), want)
    for name, ops, want, n_samples in PIPELINES:
        arr, samples = golden_pipeline(jpg, ops, DEVICE)
        if samples != n_samples:
            raise AssertionError(f"golden {name}: {samples} samples, not {n_samples}")
        out["psnr_db"][name] = golden_grade(name, arr, want)
    name, _op, kw, want = SMARTCROP
    arr, window = golden_window(smart, kw, DEVICE)
    out["psnr_db"][name] = golden_grade(name, arr, want)
    torch.cuda.synchronize()
    out["launches"] = kernels.launch_counts()
    with open(os.path.join(ROOT, "tests", "goldens", "smartcrop_window.json")) as f:
        want_window = json.load(f)
    if window != want_window:
        raise AssertionError(f"the smartcrop window {window} != {want_window}")
    out["window"] = window
    worst = min(out["psnr_db"].items(), key=lambda kv: kv[1])
    log(f"  {len(out['psnr_db'])} golden cases on the card: dims exact, lowest PSNR "
        f"{worst[1]:.2f} dB ({worst[0]}); smartcrop window {window}; launches "
        f"{ {k: v for k, v in out['launches'].items() if v} }")
    return out


# bounds of PERF.md §6 cases timed by scripts/kernel_ab.py, which reports
# no bound: (kernel, case, bytes each input read and output written once,
# operations this case's data needs)
LISTED_BOUNDS = (
    # K8: 5 operations a pixel (3 multiplies, 2 adds), in and out same shape
    ("gray", "config3-u8-C4 [1, 736, 1280, 4] uint8 in and out",
     2 * 736 * 1280 * 4, 5.0 * 736 * 1280),
    ("gray", "shard-unaligned-C3 [1, 368, 160, 3] f32", 2 * 368 * 160 * 3 * 4,
     5.0 * 368 * 160),
    ("gray", "shard-unaligned-C4-u8 [1, 368, 160, 4] uint8", 2 * 368 * 160 * 4,
     5.0 * 368 * 160),
    # K9: config4_kernel_phase's 47 operations a pixel; the integral image
    # [B, Hb + 1, Wb + 1] f32 out
    ("saliency", "uint8 B=1 [1, 320, 640, 3]", 320 * 640 * 3 + 321 * 641 * 4,
     47.0 * 320 * 640),
    ("saliency", "2160x3840 f32 B=1", 2160 * 3840 * 3 * 4 + 2161 * 3841 * 4,
     47.0 * 2160 * 3840),
    # K10 on SAL_SEAM_CASES' 320x640 (B=2): the integral image entries its
    # candidates read, once, two offsets out; 4 operations a candidate
    # window, (300, 300) over 300x533 valid and (1, 1) over 320x640
    ("window_argmax", "320x640, windows 300x300 and 1x1",
     k10_work(300, 533, 300, 300, 320, 640)[0] + k10_work(320, 640, 1, 1, 320, 640)[0],
     k10_work(300, 533, 300, 300, 320, 640)[1] + k10_work(320, 640, 1, 1, 320, 640)[1]),
)


def listed_bounds() -> list:
    rows = []
    for name, case, nbytes, flops in LISTED_BOUNDS:
        b, by = bound_ms(nbytes, flops)
        rows.append({"name": name, "case": case, "bytes": nbytes, "flops": flops,
                     "bound_ms": b, "bound_by": by})
        log(f"  bound {name} [{case}]: {b:.6f} ms by {by} ({nbytes} bytes, "
            f"{flops:.0f} operations)")
    return rows


def chain_plain_phase(png: bytes) -> dict:
    """Phase 13(d): config 3's chain (K1 -> K6 -> K7, the spatial route's
    chain row) on the card, whole, launched by the kernels and by their
    plain versions (the stages run over `kernels.reference`), on one
    staged input: device time of each and their largest difference."""
    import numpy as np
    import torch

    from imaginary_tpu_torch.kernels import reference
    from imaginary_tpu_torch.ops import chain, stages

    arr, plan = pipeline_request(png, CONFIG3_OPS, "rgb")
    specs = plan.spec_key()
    batch = chain.pad_to_bucket(arr)
    host_dyns = chain._stack_dyns([plan])
    flat = [[batch], np.array([arr.shape[0]], np.int32), np.array([arr.shape[1]], np.int32)]
    flat += [v for d in host_dyns for v in d.values()]
    views, _host = chain._stage(flat, torch.device(DEVICE))

    def run():
        return chain._run_staged(specs, views, host_dyns)

    real = stages.kernels
    got = run()
    ms = device_ms(run)
    try:
        stages.kernels = reference
        want = run()
        plain = device_ms(run)
    finally:
        stages.kernels = real
    err = max_err(got, want)
    if err > U8_TOL:
        raise AssertionError(f"config 3's chain against its plain version: {err} LSB")
    names = " -> ".join(type(s).__name__ for s in specs)
    log(f"  config 3's chain ({names}) on [1, {batch.shape[0]}, {batch.shape[1]}, 3]: "
        f"{ms:.4f} ms, plain {plain:.4f} ms, max |diff| {err}")
    return {"ms": ms, "plain_ms": plain, "max_abs_err": err, "specs": names}


# -- phase 14: the card's fault domain and the host placement ------------------

# Config 1's answers of phase 4's server, held byte-equal in phase 14.
PHASE4_ANSWERS: dict = {}
# (server, spilled, breaker_host_served, hedges launched) of every server
# of phases 4-13, read from its /health before it closed (None: unread).
HOST_PLACEMENTS: list = []
CONFIG1_GET = "/resize?width=300&height=200&file=large.jpg"
FAULT_REQUESTS = 20
FAULT_CLEAN_PROBES = 3
FAULT_COOLDOWN_S = 2.0
OOM_BURST = 8
OOM_FRAMES = 16
OOM_FIT = 2  # the chunk size the memory cap must still admit
WATCHDOG_S = 2.0
HEDGE_MS = 50.0
HEDGE_DELAY = "300ms"
HEDGE_CALM = 20
HEDGE_SETTLE_S = 1.0
FAILSLOW_DELAY = "30ms"
FAILSLOW_LANE = 1
INTEGRITY_TOL, INTEGRITY_MEAN = 96, 16.0  # engine/integrity.py's bars


def note_host_placements(name: str, health) -> None:
    if health is None:
        HOST_PLACEMENTS.append((name, None, None, None))
        return
    ex = health["executor"]
    HOST_PLACEMENTS.append((name, ex["spilled"], ex["breaker_host_served"],
                            ex["hedges"]["launched"]))


def watch_servers():
    """Every in-process server reads its /health block (the service's
    `health()`, the one assembly /health serves) into HOST_PLACEMENTS as
    it closes; returns the function that stops watching."""
    from imaginary_tpu_torch.web import app as app_mod

    real = app_mod.AppServer.server_close

    def server_close(self):
        try:
            note_host_placements(f"{self.service.device}:{self.server_address[1]}",
                                 self.service.health())
        finally:
            real(self)

    app_mod.AppServer.server_close = server_close

    def restore():
        app_mod.AppServer.server_close = real

    return restore


def host_placement_check() -> dict:
    """Phases 4-13 served every request on the card: no spill, no host
    serving for an outage, no hedge, on any of their servers."""
    bad = [h for h in HOST_PLACEMENTS if h[1:] != (0, 0, 0)]
    if not HOST_PLACEMENTS or bad:
        raise AssertionError(f"servers of phases 4-13 placed work on the host: {bad} "
                             f"(of {len(HOST_PLACEMENTS)})")
    log(f"  phases 4-13: {len(HOST_PLACEMENTS)} servers, each spilled 0, "
        f"breaker_host_served 0, hedges_launched 0 (/health)")
    return {"servers": len(HOST_PLACEMENTS)}


def backend(headers: dict) -> str:
    return headers.get("X-Imaginary-Backend", "")


def per_device(health: dict, idx: int = 0) -> dict:
    return health["deviceHealth"]["per_device"][idx]


def integrity_case(smi: str) -> dict:
    """(a): config 1 with --integrity --integrity-sample 1.0
    --failslow-ratio 3 --host-spill on: every chunk verified on the card,
    then device.corrupt (the outage served by the host), then the golden
    probe's re-admission."""
    import numpy as np
    import torch

    from imaginary_tpu_torch import failpoints, kernels
    from imaginary_tpu_torch.engine import integrity as integrity_mod
    from imaginary_tpu_torch.ops import chain as chain_mod
    from imaginary_tpu_torch.web.app import make_server

    want = PHASE4_ANSWERS["resize"]
    srv = make_server("127.0.0.1", 0, device=DEVICE, mount=TESTDATA, integrity=True,
                      integrity_sample=1.0, integrity_clean_probes=FAULT_CLEAN_PROBES,
                      failslow_ratio=3.0, breaker_cooldown_s=FAULT_COOLDOWN_S,
                      host_spill=True)
    stop = start(srv)
    port = srv.server_address[1]
    svc = srv.service
    ex = svc.executor
    out: dict = {}
    try:
        http_get(port, CONFIG1_GET)  # warm
        c0, b0 = svc.integrity.checks, ex.stats.batches
        for _ in range(FAULT_REQUESTS):
            status, headers, body = http_get(port, CONFIG1_GET)
            if (status, backend(headers)) != (200, "device") or body != want:
                raise AssertionError(f"(a) clean: {status} {backend(headers)}, "
                                     f"byte-equal {body == want}")
        checks, chunks = svc.integrity.checks - c0, ex.stats.batches - b0
        if checks != chunks or svc.integrity.mismatches != 0 or ex.stats.spilled != 0:
            raise AssertionError(f"(a) {checks} checks for {chunks} chunks, "
                                 f"{svc.integrity.mismatches} mismatches, "
                                 f"{ex.stats.spilled} spilled")
        if not wait_for(lambda: per_device(svc.health())["probe_latency_samples"] >= 1, 10):
            raise AssertionError("(a) the golden probe never ran")
        probe_ewma = per_device(svc.health())["probe_latency_ewma_ms"]
        warm_ms = [ex._probe_device(0) for _ in range(5)]
        arr, plan, ref = integrity_mod.golden()
        card = chain_mod.run_batch([arr], [plan], device=DEVICE)[0]
        d = np.abs(card.astype(np.int16) - ref.astype(np.int16))
        out["clean"] = {"requests": FAULT_REQUESTS, "checks": checks, "chunks": chunks,
                        "golden_probe_ms": sorted(warm_ms)[2],
                        "golden_probe_ewma_ms": probe_ewma,
                        "golden_max_abs_diff": int(d.max()),
                        "golden_mean_abs_diff": float(d.mean())}
        log(f"  (a) {FAULT_REQUESTS} GETs on the card, byte-equal to phase 4's, {checks} "
            f"checks = {chunks} chunks, 0 mismatches; golden probe warm "
            f"{sorted(warm_ms)[2]:.3f} ms (EWMA {probe_ewma:.3f} ms), the card's golden "
            f"output max |d| {int(d.max())} mean |d| {float(d.mean()):.3f} against the "
            f"host's  [{smi}]")
        failpoints.activate("device.corrupt=error")
        try:
            heads = []
            for _ in range(3):
                status, headers, _ = http_get(port, CONFIG1_GET)
                heads.append((status, backend(headers)))
            h = svc.health()
        finally:
            failpoints.deactivate()
        integ, dh = h["integrity"], per_device(h)
        if heads != [(200, "host")] * 3 or integ["mismatches"] < 1 \
                or integ["reserved"] < 1 or dh["corruptions"] < 1 \
                or h["executor"]["breaker_host_served"] < 1 or dh["state"] == "healthy":
            raise AssertionError(f"(a) device.corrupt: answers {heads}, integrity {integ}, "
                                 f"device {dh}, executor {h['executor']}")
        out["corrupt"] = {"answers": heads, "mismatches": integ["mismatches"],
                          "reserved": integ["reserved"], "corruptions": dh["corruptions"],
                          "breaker_host_served": h["executor"]["breaker_host_served"]}
        log(f"  (a) device.corrupt: 3 answers 200 host, {integ['mismatches']} mismatches, "
            f"{integ['reserved']} re-served, {dh['corruptions']} corruption strikes, "
            f"quarantined, breaker_host_served {h['executor']['breaker_host_served']}")
        t0 = time.perf_counter()
        if not wait_for(lambda: per_device(svc.health())["state"] == "healthy", 30):
            raise AssertionError(f"(a) not re-admitted: {per_device(svc.health())}")
        dh = per_device(svc.health())
        if dh["readmissions"] < 1 or dh["clean_probes_needed"] != 0:
            raise AssertionError(f"(a) re-admission: {dh}")
        kernels.reset_launches()
        for _ in range(3):
            status, headers, body = http_get(port, CONFIG1_GET)
            if (status, backend(headers), body == want) != (200, "device", True):
                raise AssertionError(f"(a) after re-admission: {status} {backend(headers)}")
        launches = kernels.launch_counts()
        if launches["yuv420_unpack"] != 3 or launches["yuv420_pack"] != 3:
            raise AssertionError(f"(a) after re-admission the requests launched {launches}")
        out["readmitted"] = {"seconds": time.perf_counter() - t0, "probes": dh["probes"],
                             "readmissions": dh["readmissions"]}
        log(f"  (a) failpoint cleared: re-admitted by the golden probe after "
            f"{time.perf_counter() - t0:.2f} s ({dh['probes']} probes, clean-probe debt "
            f"{FAULT_CLEAN_PROBES}); 3 answers on the card again, K2 and K3 launched 3 "
            f"times each")
    finally:
        failpoints.deactivate()
        stop()
    torch.cuda.synchronize()
    return out


def burst(port: int, path: str, n: int, body=None) -> list:
    """n requests of `path` started together, POSTs of `body` when one is
    given: [(status, headers, body)]."""
    got: list = [None] * n
    gate = threading.Barrier(n)
    headers = {"Content-Type": "image/jpeg"} if body is not None else None

    def one(i):
        gate.wait()
        got[i] = http_get(port, path, headers=headers,
                          method="POST" if body is not None else "GET", body=body)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return got


def oom_case(smi: str) -> dict:
    """(b): device.oom on a B=8 chunk of phase 6's /thumbnail through the
    server, then a real torch.cuda.OutOfMemoryError under a per-process
    memory cap on an in-process executor."""
    from imaginary_tpu_torch import failpoints
    from imaginary_tpu_torch.web.app import make_server

    with open(LARGE_JPG, "rb") as f:
        buf = f.read()
    path = CONFIG2_REQUESTS[0][0]
    out: dict = {}
    srv = make_server("127.0.0.1", 0, device=DEVICE, max_batch=OOM_BURST,
                      batch_form_ms=500.0, cpus=2 * OOM_BURST)
    stop = start(srv)
    ex = srv.service.executor
    try:
        port = srv.server_address[1]
        http_get(port, path, headers={"Content-Type": "image/jpeg"}, method="POST", body=buf)
        plain = burst(port, path, OOM_BURST, buf)
        failpoints.activate("device.oom=once(error)")
        got = burst(port, path, OOM_BURST, buf)
        failpoints.deactivate()
        st = ex.stats
        want = {p[2] for p in plain}
        if len(want) != 1 or any(g[0] != 200 or g[2] not in want or backend(g[1]) != "device"
                                 for g in got) or st.oom_events < 1 or st.oom_splits < 1:
            raise AssertionError(f"(b) device.oom: statuses {[g[0] for g in got]}, "
                                 f"oom_events {st.oom_events}, oom_splits {st.oom_splits}, "
                                 f"byte-equal {[g[2] in want for g in got]}")
        out["failpoint"] = {"answers": len(got), "oom_events": st.oom_events,
                            "oom_splits": st.oom_splits, "max_group": st.max_group_seen}
        log(f"  (b) device.oom on a B={st.max_group_seen} /thumbnail chunk: "
            f"{len(got)} answers 200 on the card, byte-equal to the unsplit run; "
            f"oom_events {st.oom_events}, oom_splits {st.oom_splits}")
    finally:
        failpoints.deactivate()
        stop()
    out["real"] = real_oom_case()
    return out


def real_oom_case() -> dict:
    """(b), second half: a real torch.cuda.OutOfMemoryError. An in-process
    executor under torch.cuda.set_per_process_memory_fraction, the cap
    chosen from the allocator's measured need for a B=2 chunk of 4K frames
    (and torch.cuda.mem_get_info's total) so that B=2 fits and B=4 and
    up do not; the B=16 chunk is bisected and served on the card."""
    import numpy as np
    import torch

    from imaginary_tpu_torch.engine import Executor, ExecutorConfig
    from imaginary_tpu_torch.ops import chain as chain_mod
    from imaginary_tpu_torch.ops.plan import plan_operation
    from imaginary_tpu_torch.options import ImageOptions

    rng = np.random.default_rng(SEED)
    base = rng.integers(0, 256, (2160 // 8, 3840 // 8, 3), dtype=np.uint8)
    frame = np.kron(base, np.ones((8, 8, 1), np.uint8))
    frames = [np.ascontiguousarray(frame ^ np.uint8(i)) for i in range(OOM_FRAMES)]
    plan = plan_operation("resize", ImageOptions(width=1920), 2160, 3840, 0, 3)
    plans = [plan] * OOM_FRAMES
    want = chain_mod.run_batch(frames, plans, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_mb = torch.cuda.memory_reserved() / 2**20
    torch.cuda.reset_peak_memory_stats()
    chain_mod.run_batch(frames[:OOM_FIT], plans[:OOM_FIT], device=DEVICE)
    need_fit = torch.cuda.max_memory_reserved() / 2**20 - base_mb
    torch.cuda.empty_cache()
    _, total = torch.cuda.mem_get_info()
    cap_mb = torch.cuda.memory_reserved() / 2**20 + 1.5 * need_fit
    fraction = cap_mb * 2**20 / total
    ex = Executor(ExecutorConfig(device=DEVICE, max_batch=OOM_FRAMES, max_form_ms=500.0))
    torch.cuda.set_per_process_memory_fraction(fraction)
    try:
        futs = [ex.submit(f, plan) for f in frames]
        got = [f.result(timeout=120) for f in futs]
        placed = [getattr(f, "_hedge_placement", None) for f in futs]
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
        ex.shutdown()
    st = ex.stats
    last = ex.devhealth.record(0).last_error
    equal = all(np.array_equal(g, w) for g, w in zip(got, want))
    if not equal or st.oom_events != 1 or st.oom_splits < 1 or st.oom_host_routed \
            or any(placed) or "out of memory" not in last.lower():
        raise AssertionError(f"(b) real OOM: bit-equal {equal}, oom_events {st.oom_events}, "
                             f"oom_splits {st.oom_splits}, host-routed {st.oom_host_routed}, "
                             f"last error {last!r}")
    out = {"frames": OOM_FRAMES, "cap_mb": cap_mb, "b2_need_mb": need_fit,
           "total_mb": total / 2**20, "oom_events": st.oom_events,
           "oom_splits": st.oom_splits, "error": last[:160]}
    log(f"  (b) real OOM: B={OOM_FRAMES} 4K frames under a {cap_mb:.0f} MB cap (B={OOM_FIT} "
        f"needs {need_fit:.0f} MB more than the {base_mb:.0f} MB reserved): "
        f"{last.splitlines()[0][:80]!r}; bisected ({st.oom_splits} splits) and served on "
        f"the card, bit-equal to the uncapped run")
    return out


def watchdog_case() -> dict:
    """(c): a drain that hangs (the reference's own test of its watchdog,
    a fetch that blocks) is abandoned after WATCHDOG_S."""
    import numpy as np
    import torch

    from imaginary_tpu_torch.engine import Executor, ExecutorConfig
    from imaginary_tpu_torch.engine import executor as ex_mod
    from imaginary_tpu_torch.ops import chain as chain_mod
    from imaginary_tpu_torch.ops.plan import plan_operation
    from imaginary_tpu_torch.options import ImageOptions

    release = threading.Event()
    real = chain_mod.fetch_batch
    calls = {"n": 0}

    def hang_once(y, arrs, plans):
        calls["n"] += 1
        if calls["n"] == 1:
            release.wait(timeout=60)
        return real(y, arrs, plans)

    arr = np.random.default_rng(SEED).integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    plan = plan_operation("resize", ImageOptions(width=300, height=200), 1080, 1920, 0, 3)
    ex = Executor(ExecutorConfig(device=DEVICE, drain_watchdog_s=WATCHDOG_S,
                                 breaker_cooldown_s=1.0))
    chain_mod.fetch_batch = hang_once
    try:
        t0 = time.perf_counter()
        fut = ex.submit(arr, plan)
        try:
            fut.result(timeout=30)
            raise AssertionError("(c) the hung drain answered")
        except RuntimeError as e:
            if "watchdog" not in str(e):
                raise
            err = str(e)
        failed_s = time.perf_counter() - t0
        release.set()
        if not wait_for(lambda: ex.stats.device_owed_mb == 0.0, 10):
            raise AssertionError(f"(c) owed MB {ex.stats.device_owed_mb}")
        if not wait_for(lambda: not ex._breaker_is_open(), 10):
            raise AssertionError("(c) the breaker stayed open")
        ex_mod.reset_placement()
        again = ex.process(arr, plan, timeout=60)
        placed = ex_mod.last_placement()
    finally:
        chain_mod.fetch_batch = real
        release.set()
        ex.shutdown()
    if placed != "device" or again.shape != (200, 300, 3) or ex.stats.breaker_opens != 1:
        raise AssertionError(f"(c) after the watchdog: {placed}, {again.shape}, "
                             f"breaker_opens {ex.stats.breaker_opens}")
    torch.cuda.synchronize()
    log(f"  (c) drain watchdog {WATCHDOG_S:.0f} s: the hung chunk failed after "
        f"{failed_s:.2f} s with {err!r}, owed MB back to 0, the breaker opened once, "
        f"the next request served on the card")
    return {"failed_after_s": failed_s, "error": err}


def hedge_case() -> dict:
    """(d): --hedge-threshold-ms 50 with device.slow delaying the card."""
    from imaginary_tpu_torch import failpoints
    from imaginary_tpu_torch.web.app import make_server

    srv = make_server("127.0.0.1", 0, device=DEVICE, mount=TESTDATA,
                      hedge_threshold_ms=HEDGE_MS, request_timeout_s=30.0)
    stop = start(srv)
    ex = srv.service.executor
    port = srv.server_address[1]
    try:
        http_get(port, CONFIG1_GET)
        failpoints.activate(f"device.slow=delay({HEDGE_DELAY})")
        slow = [http_get(port, CONFIG1_GET) for _ in range(3)]
        failpoints.deactivate()
        # the cancelled device items' delayed launches end before the calm
        # requests start
        time.sleep(HEDGE_SETTLE_S)
        won = ex.stats.hedges_won
        if [(s, backend(h)) for s, h, _ in slow] != [(200, "host")] * 3 or won < 3:
            raise AssertionError(f"(d) slow card: {[(s, backend(h)) for s, h, _ in slow]}, "
                                 f"hedges_won {won}")
        launched = ex.stats.hedges_launched
        calm = [http_get(port, CONFIG1_GET) for _ in range(HEDGE_CALM)]
        if ex.stats.hedges_launched != launched or any(
                (s, backend(h)) != (200, "device") for s, h, _ in calm):
            raise AssertionError(f"(d) calm card launched "
                                 f"{ex.stats.hedges_launched - launched} hedges")
        failpoints.activate(f"device.slow=delay({HEDGE_DELAY})")
        short = http_get(port, CONFIG1_GET, headers={"X-Request-Timeout": "0.04"})
        failpoints.deactivate()
        time.sleep(HEDGE_SETTLE_S)  # past the delayed launch
        if ex.stats.hedges_launched != launched or short[0] not in (503, 504):
            raise AssertionError(f"(d) a 40 ms deadline: {short[0]}, "
                                 f"{ex.stats.hedges_launched - launched} hedges")
    finally:
        failpoints.deactivate()
        stop()
    log(f"  (d) hedging at {HEDGE_MS:.0f} ms: device.slow {HEDGE_DELAY} -> 3 answers from "
        f"the host twin (hedges_won {won}); {HEDGE_CALM} calm requests launched 0 hedges; "
        f"a 40 ms X-Request-Timeout launched none ({short[0]})")
    return {"hedges_won": won, "calm_requests": HEDGE_CALM, "short_deadline_status": short[0]}


def failslow_case() -> dict:
    """(e): four lanes on card 0 (phase 10's layout), device.slow keyed to
    one lane: demoted, its work moves, re-admitted once cleared."""
    from imaginary_tpu_torch import failpoints
    from imaginary_tpu_torch.web.app import make_server

    entries = [f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE] * LANE_ENTRIES
    srv = make_server("127.0.0.1", 0, device=DEVICE, mount=TESTDATA, mesh_policy="lanes",
                      devices=entries, failslow_ratio=3.0, failslow_min_samples=4,
                      breaker_cooldown_s=0.25, cpus=8)
    stop = start(srv)
    ex = srv.service.executor
    port = srv.server_address[1]
    lane = ex._lanes.lane(FAILSLOW_LANE)

    def traffic(n=16):
        got = burst(port, CONFIG1_GET, n)
        if any((s, backend(h)) != (200, "device") for s, h, _ in got):
            raise AssertionError(f"(e) answers {[(s, backend(h)) for s, h, _ in got]}")

    try:
        traffic()
        failpoints.activate(f"device.slow[{FAILSLOW_LANE}]=delay({FAILSLOW_DELAY})")
        t0 = time.perf_counter()
        if not wait_for(lambda: not lane.active, 30):
            raise AssertionError(f"(e) lane {FAILSLOW_LANE} stayed in the rotation: "
                                 f"{per_device(srv.service.health(), FAILSLOW_LANE)}")
        demoted_s = time.perf_counter() - t0
        d0 = lane.dispatches
        traffic()
        moved = lane.dispatches == d0
        rec = per_device(srv.service.health(), FAILSLOW_LANE)
        failpoints.deactivate()
        t0 = time.perf_counter()
        if not wait_for(lambda: lane.active and per_device(
                srv.service.health(), FAILSLOW_LANE)["state"] == "healthy", 60):
            raise AssertionError(f"(e) lane {FAILSLOW_LANE} not re-admitted: "
                                 f"{per_device(srv.service.health(), FAILSLOW_LANE)}")
        back_s = time.perf_counter() - t0
        traffic()
    finally:
        failpoints.deactivate()
        stop()
    if not moved or rec["demotions"] < 1:
        raise AssertionError(f"(e) demotions {rec['demotions']}, work moved {moved}")
    log(f"  (e) device.slow[{FAILSLOW_LANE}] {FAILSLOW_DELAY} on lane {FAILSLOW_LANE} of "
        f"{LANE_ENTRIES}: demoted after {demoted_s:.2f} s (probe EWMA "
        f"{rec['probe_latency_ewma_ms']:.2f} ms, state {rec['state']}), 16 requests moved "
        f"off it; re-admitted {back_s:.2f} s after the failpoint cleared")
    return {"demoted_after_s": demoted_s, "readmitted_after_s": back_s,
            "probe_ewma_ms": rec["probe_latency_ewma_ms"], "state": rec["state"]}


def force_host_case(smi: str) -> dict:
    """(f): --force-host on config 1: the host answers, counted, no kernel
    launched, within the integrity bars of the card's answer."""
    import numpy as np

    from imaginary_tpu_torch import codecs, kernels
    from imaginary_tpu_torch.web.app import make_server

    srv = make_server("127.0.0.1", 0, device=DEVICE, mount=TESTDATA, force_host=True)
    stop = start(srv)
    try:
        port = srv.server_address[1]
        kernels.reset_launches()
        status, headers, body = http_get(port, CONFIG1_GET)
        launches = kernels.launch_counts()
        spilled = srv.service.executor.stats.spilled
    finally:
        stop()
    if (status, backend(headers), spilled) != (200, "host", 1) or any(launches.values()):
        raise AssertionError(f"(f) --force-host: {status} {backend(headers)}, spilled "
                             f"{spilled}, launches {launches}")
    host = codecs.decode(body).array.astype(np.int16)
    card = codecs.decode(PHASE4_ANSWERS["resize"]).array.astype(np.int16)
    d = np.abs(host - card)
    if host.shape != card.shape or d.max() > INTEGRITY_TOL or d.mean() > INTEGRITY_MEAN:
        raise AssertionError(f"(f) host answer max |d| {d.max()} mean {d.mean():.2f}")
    log(f"  (f) --force-host: 200 host, spilled 1, no kernel launched; against the "
        f"card's answer max |d| {int(d.max())} mean |d| {float(d.mean()):.3f} "
        f"(bars {INTEGRITY_TOL}, {INTEGRITY_MEAN})  [{smi}]")
    return {"max_abs_diff": int(d.max()), "mean_abs_diff": float(d.mean())}


def fault_domain_phase(smi: str) -> dict:
    t0 = time.perf_counter()
    out = {"phases_4_13": host_placement_check()}
    cases = (("integrity", lambda: integrity_case(smi)), ("oom", lambda: oom_case(smi)),
             ("watchdog", watchdog_case), ("hedging", hedge_case),
             ("failslow", failslow_case), ("force_host", lambda: force_host_case(smi)))
    seconds = {}
    for name, case in cases:
        t = time.perf_counter()
        out[name] = case()
        seconds[name] = time.perf_counter() - t
    out["seconds"] = {"total": time.perf_counter() - t0, **seconds}
    log(f"  phase 14: {out['seconds']['total']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()) + ")")
    return out


# --- phase 15: the executor's admission half on the card --------------------

# (a)'s servers: one host-pool worker per client (so a key's items meet in
# the executor, as in phase 10(b)/(c)) and chunks of at most 4, so a
# convoy group of a key's 8 items takes 2 launches
ADMISSION_BATCHING = ["--max-batch", "4", "--cpus", "32"]
ADMISSION_WINDOW_MS = 3.0  # --batch-window-ms of (a)'s convoy server
ADMISSION_COMMON_CLIENTS = 8
# (b): the byte cap's width in config 1 items at the rung the memory.rss
# failpoint holds (it reads as RSS at the ceiling: the critical rung,
# whose cap is half of --pressure-batch-mb); the governed server's
# --max-allowed-resolution (its critical clamp is a quarter: 15 MP) and
# --pressure-oversize-mpix, so config 3's 8.3 MP frame stays on the card,
# a 13 MP source is forced to the host and a 16 MP source clamped
PRESSURE_CAP_ITEMS = 2.5
GOVERNED_MAX_RES = 60.0
GOVERNED_OVERSIZE_MPIX = 12.0
OVERSIZE_SRC = (3000, 4400)  # 13.2 MP
CLAMPED_SRC = (3400, 4800)  # 16.3 MP
PRESSURE_BURST = (16, 8)  # config 1 requests, then config 3's
SAMPLE_WAIT_S = 0.3  # past the governor's 0.25 s sample interval
# (c): an interactive and a batch tenant splitting phase 6's mix; the
# batch tenant's queue share is one item of a 16-item intake queue
ADMISSION_QOS = {
    "default": {"class": "standard"}, "queue_cap": 16,
    "tenants": [{"name": "gold", "class": "interactive", "api_keys": ["chip-gold"]},
                {"name": "bulk", "class": "batch", "api_keys": ["chip-bulk"],
                 "max_share": 0.0625}]}
QOS_KEYS = ("chip-gold", "chip-bulk")
ADMISSION_MAX_QUEUE_MS = 20.0
# one host-pool worker per client, and one group in flight: items wait in
# the intake queue while the collector is held by the drain, where the
# share cap and the queue estimate act
ADMISSION_QOS_LOAD = ["--cpus", "32", "--max-inflight", "1"]
# (d) and (e)
DONATION_BATCHES = {"config1": 16, "config3": 8}
WIRE_REQUESTS = 5
ARENA_MB = 64.0
DRAIN_CLIENTS = 8
DRAIN_LOAD_S = 1.0


def admission_server(args: list):
    """The port's server from its command line (`cli.parse_args`) with
    --prewarm on DEVICE, mounted on tests/testdata, its access log dropped
    (the shed 503s would flood the output), serving on a thread: (server,
    stop)."""
    from imaginary_tpu_torch import cli
    from imaginary_tpu_torch.web import app as app_mod

    o = cli.options_from_args(cli.parse_args(
        ["--addr", "127.0.0.1", "--port", "0", "--device", DEVICE, "--log-level", "error",
         "--mount", TESTDATA, "--prewarm"] + list(args)))
    srv = app_mod.AppServer(o, log_stream=app_mod._Discard())
    return srv, start(srv)


def tolerant_load(port: int, reqs: list, clients: int, per_client: int) -> tuple:
    """load_window whose answers may be errors: reqs are (path, body,
    headers); (wall seconds, [(request index, client, ms, status, headers,
    body)])."""
    n_req = clients * per_client
    results: list = [None] * n_req
    errors: list = []
    begin = threading.Barrier(clients + 1)

    def client(t: int) -> None:
        begin.wait()
        try:
            for i in range(per_client):
                n = t * per_client + i
                k = n % len(reqs)
                path, body, headers = reqs[k]
                t0 = time.perf_counter()
                status, hdrs, out = http_get(
                    port, path, headers(t) if callable(headers) else headers,
                    "POST" if body is not None else "GET", body)
                results[n] = (k, t, (time.perf_counter() - t0) * 1e3, status, hdrs, out)
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(clients)]
    for th in threads:
        th.start()
    begin.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return time.perf_counter() - t0, results


def add_launches(total: dict, got: dict) -> None:
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def common_pass(srv) -> int:
    """Each prewarm `_COMMON` route from ADMISSION_COMMON_CLIENTS clients at
    once (chunks of several B); every answer 200. Returns the server's
    compile_misses after."""
    port = srv.server_address[1]
    for path, _ in common_routes():
        _, got = tolerant_load(port, [(path, None, {})], ADMISSION_COMMON_CLIENTS, 1)
        bad = [r[3] for r in got if r[3] != 200]
        if bad:
            raise AssertionError(f"{path}: {bad}")
    return srv.service.executor.stats.compile_misses


def mix_window_stats(srv, results, walls, before: dict) -> dict:
    import numpy as np

    from imaginary_tpu_torch.engine.timing import TIMES

    st = srv.service.executor.stats
    items, batches = st.items - before["items"], st.batches - before["batches"]
    groups = st.groups - before["groups"]
    snap = TIMES.snapshot()
    lat = [r[2] for r in results]
    return {"requests": len(results),
            "rps": statistics.median([CLIENTS * PER_CLIENT / wl for wl in walls]),
            "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "items": items, "batches": batches, "groups": groups,
            "avg_batch": items / max(1, batches), "avg_group": items / max(1, groups),
            "batch_form_p50_ms": snap["batch_form"]["p50_ms"],
            "batch_form_p99_ms": snap["batch_form"]["p99_ms"],
            "dispatch_wait_p50_ms": snap["dispatch_wait"]["p50_ms"],
            "dispatch_wait_p99_ms": snap["dispatch_wait"]["p99_ms"],
            "compile_misses": st.compile_misses - before["compile_misses"]}


def convoy_case(smi: str, bodies: dict, cont, launches: dict) -> dict:
    """(a) phase 6's mix on --batch-policy convoy and on the default
    continuous policy (`cont`, kept open for (b)): every convoy answer
    byte-equal to the continuous server's answer to the same request,
    groups < batches under convoy, compile_misses 0 on both after the
    prewarmed `_COMMON` routes."""
    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.engine.timing import TIMES

    reqs = [(path, bodies[src], {}) for path, src, _ in CONFIG2_REQUESTS]
    convoy, stop_convoy = admission_server(
        ["--batch-policy", "convoy", "--batch-window-ms", str(ADMISSION_WINDOW_MS)]
        + ADMISSION_BATCHING)
    out: dict = {}
    try:
        want = None
        for label, srv in (("continuous", cont[0]), ("convoy", convoy)):
            port = srv.server_address[1]
            misses = common_pass(srv)
            if misses:
                raise AssertionError(f"(a) {label}: {misses} compile misses on the "
                                     "prewarmed routes")
            alone = []
            for path, body, _ in reqs:  # each route alone, after one warm request
                http(port, path, body)
                alone.append(http(port, path, body)[2])
            if want is None:
                want = alone
            ex = srv.service.executor
            before = {"items": ex.stats.items, "batches": ex.stats.batches,
                      "groups": ex.stats.groups, "compile_misses": ex.stats.compile_misses}
            kernels.reset_launches()
            TIMES.reset()
            walls, results = [], []
            for _ in range(WINDOWS):
                wall, got = tolerant_load(port, reqs, CLIENTS, PER_CLIENT)
                walls.append(wall)
                results.extend(got)
            add_launches(launches, kernels.launch_counts())
            bad = [r for r in results if (r[3], r[5]) != (200, want[r[0]])]
            if bad:
                raise AssertionError(f"(a) {label}: {len(bad)} of {len(results)} answers "
                                     f"differ from the continuous server's alone answers "
                                     f"(first {CONFIG2_REQUESTS[bad[0][0]][0]}, {bad[0][3]})")
            got = out[label] = mix_window_stats(srv, results, walls, before)
            got["common_compile_misses"] = misses
            log(f"  (a) {label:10s}: {got['rps']:.1f} req/s, p50 {got['p50_ms']:.2f} ms, "
                f"p99 {got['p99_ms']:.2f} ms, avg_batch {got['avg_batch']:.2f}, "
                f"avg_group {got['avg_group']:.2f} ({got['groups']} groups, "
                f"{got['batches']} batches), batch_form p50/p99 "
                f"{got['batch_form_p50_ms']:.2f}/{got['batch_form_p99_ms']:.2f} ms, "
                f"dispatch_wait p50/p99 {got['dispatch_wait_p50_ms']:.2f}/"
                f"{got['dispatch_wait_p99_ms']:.2f} ms, compile_misses 0 on the prewarmed "
                f"routes, {got['compile_misses']} under the mix  [{smi}]")
    finally:
        stop_convoy()
    if not out["convoy"]["groups"] < out["convoy"]["batches"]:
        raise AssertionError(f"(a) convoy: groups {out['convoy']['groups']} not below "
                             f"batches {out['convoy']['batches']}")
    out["byte_equal"] = CLIENTS * PER_CLIENT * WINDOWS
    return out


def big_jpeg(hw: tuple) -> bytes:
    """A smooth seeded RGB gradient of (h, w) as a JPEG (Pillow)."""
    import io

    import numpy as np
    from PIL import Image

    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    arr = np.stack([(xx * 255 // max(1, w - 1)), (yy * 255 // max(1, h - 1)),
                    ((xx + yy) * 255 // max(1, h + w - 2))], axis=-1).astype(np.uint8)
    out = io.BytesIO()
    Image.fromarray(arr).save(out, "JPEG", quality=85)
    return out.getvalue()


def arm_level(srv, spec: str) -> None:
    """Arm (or, with "", clear) the memory.rss failpoint and wait until the
    server's governor has sampled it (it re-samples every 0.25 s)."""
    from imaginary_tpu_torch import failpoints

    if spec:
        failpoints.activate(spec)
    else:
        failpoints.deactivate()
    time.sleep(SAMPLE_WAIT_S)
    srv.service.pressure.level()


def pressure_case(smi: str, png: bytes, cont, launches: dict) -> dict:
    """(b) the governor's byte cap on the card, at the rung the memory.rss
    failpoint holds: a burst of config 1 then config 3 requests, each
    launch within the cap (floor one item), pressure_capped_batches
    counted, every answer byte-equal to the ungoverned server's (`cont`),
    no compile miss; then a 16 MP source clamped 413 and a 13 MP source
    forced to the host, counted and marked."""
    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.engine import executor as executor_mod
    from imaginary_tpu_torch.ops import chain as chain_mod

    c1_arr, c1_plan = main_plan("resize", "yuv420")
    w1 = executor_mod._Item(c1_arr, c1_plan).wire_mb
    c3_arr, c3_plan = pipeline_request(png, CONFIG3_OPS, "rgb")
    w3 = executor_mod._Item(c3_arr, c3_plan).wire_mb
    batch_mb = 2.0 * PRESSURE_CAP_ITEMS * w1  # the critical rung caps at half
    cap_mb = batch_mb / 2.0
    config3_path = CONFIG3_REQUESTS[0][1]
    cont_port = cont[0].server_address[1]
    want1 = http_get(cont_port, CONFIG1_GET)[2]
    want3 = http(cont_port, config3_path, png)[2]
    srv, stop = admission_server([
        "--pressure-rss-mb", "1000000", "--pressure-batch-mb", f"{batch_mb:.6f}",
        "--pressure-oversize-mpix", str(GOVERNED_OVERSIZE_MPIX),
        "--max-allowed-resolution", str(GOVERNED_MAX_RES)])
    out: dict = {"wire_mb": {"config1": w1, "config3": w3}, "batch_mb": batch_mb,
                 "cap_mb": cap_mb}
    launched: list = []
    real_launch = chain_mod.launch_batch

    def spy(arrs, plans, *a, **k):
        launched.append((plans[0].spec_key() == c1_plan.spec_key(), len(arrs)))
        return real_launch(arrs, plans, *a, **k)

    try:
        port = srv.server_address[1]
        ex = srv.service.executor
        http(port, config3_path, png)  # config 3's B=1 signature, at level ok
        arm_level(srv, "memory.rss=error")
        level = srv.service.pressure.snapshot()["level"]
        st0 = ex.stats.to_dict()
        kernels.reset_launches()
        chain_mod.launch_batch = spy
        try:
            _, got1 = tolerant_load(port, [(CONFIG1_GET, None, {})], PRESSURE_BURST[0], 1)
            _, got3 = tolerant_load(port, [(config3_path, png, {})], PRESSURE_BURST[1], 1)
        finally:
            chain_mod.launch_batch = real_launch
        add_launches(launches, kernels.launch_counts())
        st1 = ex.stats.to_dict()
        bad = [r[3] for r in got1 if (r[3], r[5]) != (200, want1)]
        bad += [r[3] for r in got3 if (r[3], r[5]) != (200, want3)]
        if bad:
            raise AssertionError(f"(b) {len(bad)} answers under the cap differ from the "
                                 f"ungoverned server's: {bad[:4]}")
        c1_sizes = [n for is1, n in launched if is1]
        c3_sizes = [n for is1, n in launched if not is1]
        out.update(level=level, launches=len(launched), config1_chunks=c1_sizes,
                   config3_chunks=c3_sizes,
                   capped=st1["pressure_capped_batches"] - st0["pressure_capped_batches"],
                   misses=st1["compile_misses"] - st0["compile_misses"])
        if level != "critical" or out["capped"] <= 0:
            raise AssertionError(f"(b) level {level}, pressure_capped_batches "
                                 f"{out['capped']}")
        if max(c1_sizes) * w1 > cap_mb or max(c3_sizes) != 1:
            raise AssertionError(f"(b) a launch past the cap: config 1 {c1_sizes}, "
                                 f"config 3 {c3_sizes} (cap {cap_mb:.3f} MB)")
        if out["misses"]:
            raise AssertionError(f"(b) {out['misses']} compile misses under the cap")
        # the clamp and the oversize rung
        clamped = http_get(port, "/resize?width=300", {"Content-Type": "image/jpeg"},
                           "POST", big_jpeg(CLAMPED_SRC))
        forced0 = ex.stats.pressure_host_forced
        spilled0 = ex.stats.spilled
        kernels.reset_launches()
        # /flip decodes the whole frame (no shrink-on-load): its item is
        # the source's 13.2 MP
        forced = http_get(port, "/flip", {"Content-Type": "image/jpeg"}, "POST",
                          big_jpeg(OVERSIZE_SRC))
        forced_launches = kernels.launch_counts()
        out["clamp"] = (clamped[0], clamped[1].get("Retry-After"))
        out["forced"] = (forced[0], backend(forced[1]), ex.stats.pressure_host_forced - forced0,
                         ex.stats.spilled - spilled0)
        snap = srv.service.pressure.snapshot()
    finally:
        arm_level(srv, "")
        stop()
    if out["clamp"] != (413, "2") or snap["pixel_clamps"] < 1:
        raise AssertionError(f"(b) a {CLAMPED_SRC} source at critical: {out['clamp']}")
    if out["forced"] != (200, "host", 1, 1) or any(forced_launches.values()):
        raise AssertionError(f"(b) a {OVERSIZE_SRC} source: {out['forced']}, launches "
                             f"{forced_launches}")
    log(f"  (b) --pressure-batch-mb {batch_mb:.4f} (config 1 {w1:.4f} wire MB an item, "
        f"config 3 {w3:.3f}), held at {out['level']} by memory.rss: cap {cap_mb:.4f} MB; "
        f"{sum(PRESSURE_BURST)} requests in {out['launches']} launches (config 1 chunks "
        f"{sorted(set(c1_sizes))}, config 3 {sorted(set(c3_sizes))}), "
        f"pressure_capped_batches {out['capped']}, compile_misses 0, every answer "
        f"byte-equal to the ungoverned server's; a {CLAMPED_SRC[1]}x{CLAMPED_SRC[0]} "
        f"source 413 Retry-After 2; /flip of a {OVERSIZE_SRC[1]}x{OVERSIZE_SRC[0]} source "
        f"200 on the host, pressure_host_forced 1, no kernel launched  [{smi}]")
    return out


def qos_case(smi: str, bodies: dict, launches: dict) -> dict:
    """(c) --qos-config with an interactive and a batch key splitting phase
    6's mix (even clients interactive, odd batch) and --max-queue-ms set
    to trip under that load: per-class p50/p99, dispatched and shed, the
    share cap's 503s, nothing owed at rest; then the critical rung sheds
    the batch tenant 503 with Retry-After 2."""
    import numpy as np

    from imaginary_tpu_torch import kernels

    srv, stop = admission_server([
        "--qos-config", json.dumps(ADMISSION_QOS),
        "--max-queue-ms", str(ADMISSION_MAX_QUEUE_MS), "--pressure-rss-mb", "1000000"]
        + ADMISSION_QOS_LOAD)
    out: dict = {}
    try:
        port = srv.server_address[1]
        ex = srv.service.executor
        for path, src, _ in CONFIG2_REQUESTS:  # warm each route
            http(port, path, bodies[src])
        reqs = [(path, bodies[src], lambda t: {"API-Key": QOS_KEYS[t % 2]})
                for path, src, _ in CONFIG2_REQUESTS]
        kernels.reset_launches()
        results = []
        for _ in range(WINDOWS):
            results.extend(tolerant_load(port, reqs, CLIENTS, PER_CLIENT)[1])
        add_launches(launches, kernels.launch_counts())
        by_class: dict = {"interactive": [], "batch": []}
        sheds: dict = {}
        for _, t, ms, status, hdrs, body in results:
            cls = "interactive" if t % 2 == 0 else "batch"
            if status == 200:
                by_class[cls].append(ms)
                continue
            msg = json.loads(body).get("message", "")
            if status != 503 or not hdrs.get("Retry-After"):
                raise AssertionError(f"(c) {cls}: {status} {msg}")
            sheds[(cls, msg)] = sheds.get((cls, msg), 0) + 1
        ok = wait_for(lambda: ex.stats.device_owed_mb < 1e-6 and ex.stats.host_inflight == 0,
                      10.0)
        classes = srv.service.qos.stats.to_dict()["classes"]
        out["classes"] = classes
        out["latency"] = {c: {"served": len(v),
                              "p50_ms": float(np.percentile(v, 50)) if v else None,
                              "p99_ms": float(np.percentile(v, 99)) if v else None}
                          for c, v in by_class.items()}
        out["sheds"] = {f"{c}: {m}": n for (c, m), n in sheds.items()}
        out["at_rest"] = (ex.stats.device_owed_mb, ex.stats.host_inflight)
        # the critical rung: the batch tenant shed, the interactive one served
        arm_level(srv, "memory.rss=error")
        try:
            shed = http_get(port, CONFIG1_GET, {"API-Key": QOS_KEYS[1]})
            served = http_get(port, CONFIG1_GET, {"API-Key": QOS_KEYS[0]})
        finally:
            arm_level(srv, "")
        out["critical"] = (shed[0], shed[1].get("Retry-After"),
                           json.loads(shed[2])["message"], served[0])
    finally:
        stop()
    if not ok:
        raise AssertionError(f"(c) not at rest: owed {out['at_rest']}")
    share = sum(classes[c]["share_rejected"] for c in classes)
    shed_n = sum(classes[c]["shed"] for c in classes)
    if not share or not shed_n:
        raise AssertionError(f"(c) share_rejected {share}, shed {shed_n}: {classes}")
    if out["critical"][:2] != (503, "2") or out["critical"][3] != 200 or \
            "memory pressure" not in out["critical"][2]:
        raise AssertionError(f"(c) critical: {out['critical']}")
    for cls in ("interactive", "batch"):
        lat, c = out["latency"][cls], classes[cls]
        p50 = f"{lat['p50_ms']:.2f}" if lat["p50_ms"] is not None else "-"
        p99 = f"{lat['p99_ms']:.2f}" if lat["p99_ms"] is not None else "-"
        log(f"  (c) {cls:11s}: {lat['served']} served, p50 {p50} ms, p99 {p99} ms; "
            f"admitted {c['admitted']}, dispatched {c['dispatched']}, shed {c['shed']}, "
            f"share_rejected {c['share_rejected']}  [{smi}]")
    log(f"  (c) 503s by class and message: {out['sheds']}; at rest device_owed_mb "
        f"{out['at_rest'][0]}, host_inflight {out['at_rest'][1]}; at critical the batch "
        f"tenant 503 Retry-After 2, the interactive 200")
    return out


def chunk_peak_mb(arrs, plans, donate: bool) -> tuple:
    """(peak MB the caching allocator held above its start during one
    chunk's launch and drain, its outputs)."""
    import torch

    from imaginary_tpu_torch.ops import chain

    if DEVICE == "cpu":
        outs = chain.fetch_batch(chain.launch_batch(arrs, plans, device=DEVICE,
                                                    donate=donate), arrs, plans)
        return 0.0, outs
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    outs = chain.fetch_batch(chain.launch_batch(arrs, plans, device=DEVICE, donate=donate),
                             arrs, plans)
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20, outs


def last_stage_ms(arr, plan, spec_name: str, bsz: int, region: int) -> dict:
    """Device time of the chain's last kernel at B=bsz (its input from the
    chain's own earlier stages at B=1, repeated), writing a fresh output
    and writing into a donor region of `region` bytes a chunk."""
    import torch

    x, h, w, dyn = run_stages_until(arr, plan, spec_name, DEVICE)
    spec = next(st.spec for st in plan.stages if type(st.spec).__name__ == spec_name)
    rep = (bsz,) + (1,) * (x.dim() - 1)
    x, h, w = x.repeat(*rep), h.repeat(bsz), w.repeat(bsz)
    dyn = {k: v.repeat((bsz,) + (1,) * (v.dim() - 1)) for k, v in dyn.items()}
    fresh, _, _ = spec.apply(x, h, w, dyn, out_u8=True)
    donor = torch.empty(bsz * region, dtype=torch.uint8, device=x.device)
    view = donor[:fresh.numel() * fresh.element_size()].view(fresh.dtype).view(fresh.shape)
    donated, _, _ = spec.apply(x, h, w, dyn, out_u8=True, out=view)
    if not torch.equal(fresh, donated):
        raise AssertionError(f"{spec_name} into its donor region differs")
    if DEVICE == "cpu":
        return {"fresh_ms": None, "donated_ms": None}
    return {"fresh_ms": device_ms(lambda: spec.apply(x, h, w, dyn, out_u8=True)),
            "donated_ms": device_ms(lambda: spec.apply(x, h, w, dyn, out_u8=True, out=view))}


def donation_case(smi: str, png: bytes, launches: dict) -> dict:
    """(d) config 1 and config 3 through servers with --donation on and
    off: the answers bit-equal, the on server's launches donating; each
    route's chunk (config 1 at B=16, config 3 at B=8) launched both ways
    in-process: torch.cuda.max_memory_allocated above the start, outputs
    bit-equal; K3's and K7's device times writing fresh and donated."""
    import numpy as np

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.ops import chain as chain_mod

    config3_path = CONFIG3_REQUESTS[0][1]
    answers: dict = {}
    donated: dict = {}
    for mode in ("on", "off"):
        srv, stop = admission_server(["--donation", mode])
        try:
            port = srv.server_address[1]
            d0 = chain_mod.donation_stats()["donated"]
            kernels.reset_launches()
            answers[mode] = [http_get(port, CONFIG1_GET)[2] for _ in range(3)]
            answers[mode] += [http(port, config3_path, png)[2] for _ in range(2)]
            add_launches(launches, kernels.launch_counts())
            donated[mode] = chain_mod.donation_stats()["donated"] - d0
            enabled = srv.service.health()["executor"]["donation_enabled"]
        finally:
            stop()
        if enabled != (mode == "on"):
            raise AssertionError(f"(d) --donation {mode}: donation_enabled {enabled}")
    if answers["on"] != answers["off"]:
        raise AssertionError("(d) --donation on and off answer differently")
    if donated["on"] < 5 or donated["off"] != 0:
        raise AssertionError(f"(d) donated launches: {donated}")
    chain_mod.set_donation(True)
    rng = np.random.default_rng(SEED + 16)
    c1 = main_plan("resize", "yuv420")
    c3 = pipeline_request(png, CONFIG3_OPS, "rgb")
    out: dict = {"donated_launches": donated}
    for name, (arr, plan), spec, region in (
            ("config1", c1, "ToYuv420Spec", c1[0].nbytes),
            ("config3", c3, "CompositeSpec",
             CONFIG3_SRC_BUCKET[0] * CONFIG3_SRC_BUCKET[1] * c3[0].shape[2])):
        bsz = DONATION_BATCHES[name]
        arrs = [np.clip(arr.astype(np.int16) + rng.integers(-2, 3, arr.shape), 0,
                        255).astype(np.uint8) for _ in range(bsz)]
        plans = [plan] * bsz
        chunk_peak_mb(arrs, plans, False)  # the allocator's blocks for this shape
        off_mb, off = chunk_peak_mb(arrs, plans, False)
        on_mb, on = chunk_peak_mb(arrs, plans, True)
        if not all(planes_err(a, b) == 0 for a, b in zip(on, off)):
            raise AssertionError(f"(d) {name}: the donated chunk differs")
        out[name] = {"batch": bsz, "peak_mb_undonated": off_mb, "peak_mb_donated": on_mb,
                     **last_stage_ms(arr, plan, spec, bsz, region)}
        r = out[name]
        times = ("" if r["fresh_ms"] is None else
                 f"; its {spec} {r['fresh_ms']:.4f} ms fresh, {r['donated_ms']:.4f} ms "
                 "into the donor region")
        log(f"  (d) {name} B={bsz}: peak above start {off_mb:.2f} MB undonated, "
            f"{on_mb:.2f} MB donated, outputs bit-equal{times}  [{smi}]")
    log(f"  (d) servers: --donation on donated {donated['on']} launches, off "
        f"{donated['off']}; config 1 x3 and config 3 x2 answers bit-equal")
    return out


def wire_arena_case(smi: str, launches: dict) -> dict:
    """(e) WIRE_REQUESTS config 1 requests one at a time (B=1) on a server
    with --arena-mb: wire_bytes h2d and d2h rise by that many times the
    staged and the fetched bytes the plan gives, one transfer each way a
    request; the codec arena reuses its slots under the cap."""
    import numpy as np

    from imaginary_tpu_torch import kernels

    arr, plan = main_plan("resize", "yuv420")

    def aligned(n: int) -> int:
        return (n + 15) // 16 * 16

    staged = aligned(arr.nbytes) + 2 * aligned(4) + sum(
        aligned(np.asarray(v).nbytes) for st in plan.stages for v in st.dyn.values())
    ohb, owb = plan.out_bucket
    fetched = (ohb + ohb // 2) * owb
    srv, stop = admission_server(["--arena-mb", str(ARENA_MB)])
    try:
        port = srv.server_address[1]
        http_get(port, CONFIG1_GET)
        h0 = srv.service.health()
        kernels.reset_launches()
        for _ in range(WIRE_REQUESTS):
            if http_get(port, CONFIG1_GET)[0] != 200:
                raise AssertionError("(e) config 1 failed")
        add_launches(launches, kernels.launch_counts())
        h1 = srv.service.health()
    finally:
        stop()
    e0, e1 = h0["executor"], h1["executor"]
    got = {d: e1["wire_bytes"][d] - e0["wire_bytes"][d] for d in ("h2d", "d2h")}
    n = {d: e1["wire_transfers"][d] - e0["wire_transfers"][d] for d in ("h2d", "d2h")}
    want = {"h2d": WIRE_REQUESTS * staged, "d2h": WIRE_REQUESTS * fetched}
    if got != want or n != {"h2d": WIRE_REQUESTS, "d2h": WIRE_REQUESTS}:
        raise AssertionError(f"(e) wire bytes {got} ({n} transfers), the plan's {want}")
    a0, a1 = h0["arena"], h1["arena"]
    reuses = a1["reuses"] - a0["reuses"]
    if reuses <= 0 or a1["cap_bytes"] != int(ARENA_MB * 2**20):
        raise AssertionError(f"(e) arena {a0} -> {a1}")
    log(f"  (e) {WIRE_REQUESTS} config 1 requests at B=1: wire h2d {got['h2d']} B "
        f"({staged} staged a request), d2h {got['d2h']} B ({fetched} fetched), one "
        f"transfer each way a request; arena reuses +{reuses}, misses "
        f"+{a1['misses'] - a0['misses']}, {a1['bytes']} B held, cap {a1['cap_bytes']} B  "
        f"[{smi}]")
    return {"staged": staged, "fetched": fetched, "wire_bytes": got, "transfers": n,
            "arena": a1, "arena_reuses": reuses}


def drain_case(smi: str) -> dict:
    """(f) SIGTERM a ServerProcess (--prewarm) under DRAIN_CLIENTS keep-alive
    clients of config 1 and one /health poller: after the signal, every
    answer an in-flight 200 or a 503 with Retry-After, at least one 503,
    /health 200 on every answer until the process exits 0."""
    import http.client
    import signal

    srv = ServerProcess("drain", ["--prewarm"])
    port = srv.port
    stop = threading.Event()
    lock = threading.Lock()
    answers: list = []
    health: list = []

    def conn():
        return http.client.HTTPConnection("127.0.0.1", port, timeout=60)

    def loop(path: str, sink: list, pause: float):
        c = conn()
        while not stop.is_set():
            try:
                c.request("GET", path)
                r = c.getresponse()
                r.read()
                with lock:
                    sink.append((time.monotonic(), r.status, r.getheader("Retry-After")))
            except (OSError, http.client.HTTPException) as e:
                with lock:
                    sink.append((time.monotonic(), type(e).__name__, None))
                c.close()
                if isinstance(e, ConnectionRefusedError):
                    return
                c = conn()
            time.sleep(pause)

    threads = [threading.Thread(target=loop, args=(CONFIG1_GET, answers, 0.0))
               for _ in range(DRAIN_CLIENTS)]
    threads.append(threading.Thread(target=loop, args=("/health", health, 0.02)))
    try:
        for th in threads:
            th.start()
        time.sleep(DRAIN_LOAD_S)
        t_sig = time.monotonic()
        srv.proc.send_signal(signal.SIGTERM)
        srv.proc.wait(timeout=30)
        t_exit = time.monotonic()
        time.sleep(0.3)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=60)
        srv.stop()
    before = [a for a in answers if a[0] < t_sig]
    after = [a for a in answers if t_sig <= a[0] <= t_exit]
    shed = [a for a in after if a[1] == 503]
    bad = [a for a in before if a[1] != 200]
    bad += [a for a in after if not (a[1] == 200 or (a[1] == 503 and a[2]))
            and not isinstance(a[1], str)]
    health_alive = [h for h in health if h[0] <= t_exit and not isinstance(h[1], str)]
    if bad or not shed or any(h[1] != 200 for h in health_alive) or srv.proc.returncode != 0:
        raise AssertionError(f"(f) drain: {len(bad)} bad answers {bad[:3]}, {len(shed)} "
                             f"503s, /health {set(h[1] for h in health_alive)}, exit "
                             f"{srv.proc.returncode}")
    retry = sorted({a[2] for a in shed})
    log(f"  (f) SIGTERM under {DRAIN_CLIENTS} clients: {len(before)} answers 200 before; "
        f"{len(after)} in the {t_exit - t_sig:.2f} s to exit: "
        f"{sum(1 for a in after if a[1] == 200)} in-flight 200, {len(shed)} 503 "
        f"Retry-After {retry}; /health 200 on all {len(health_alive)} polls until exit; "
        f"exit 0  [{smi}]")
    return {"before": len(before), "after": len(after), "shed": len(shed),
            "health_polls": len(health_alive), "exit_s": t_exit - t_sig,
            "retry_after": retry}


def admission_phase(smi: str, png: bytes) -> dict:
    """Phase 15 (see the module docstring): (a)-(f), each server from the
    port's command line with --prewarm; `launches` sums the kernel
    launches of the paths each case drives."""
    with open(LARGE_JPG, "rb") as f, open(EXIF6_JPG, "rb") as g:
        bodies = {LARGE_JPG: f.read(), EXIF6_JPG: g.read()}
    t0 = time.perf_counter()
    launches: dict = {}
    out: dict = {}
    seconds: dict = {}
    cont = admission_server(ADMISSION_BATCHING)
    try:
        for name, case in (("convoy", lambda: convoy_case(smi, bodies, cont, launches)),
                           ("pressure", lambda: pressure_case(smi, png, cont, launches))):
            t = time.perf_counter()
            out[name] = case()
            seconds[name] = time.perf_counter() - t
    finally:
        cont[1]()
    for name, case in (("qos", lambda: qos_case(smi, bodies, launches)),
                       ("donation", lambda: donation_case(smi, png, launches)),
                       ("wire_arena", lambda: wire_arena_case(smi, launches)),
                       ("drain", lambda: drain_case(smi))):
        t = time.perf_counter()
        out[name] = case()
        seconds[name] = time.perf_counter() - t
    out["launches"] = {k: launches.get(k, 0) for k in KERNEL_ROWS}
    out["seconds"] = {"total": time.perf_counter() - t0, **seconds}
    log(f"  phase 15: {out['seconds']['total']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()) + ")")
    return out


# --- phase 16: the cache tiers on the card -----------------------------------

CACHE_SERIAL = 8  # (a): sequential config 1 requests a server
CACHE_BATCHING = ["--max-batch", "4"]  # keeps each server's prewarm short
COALESCE_CLIENTS = 32  # (b)
COALESCE_HOLD = "100ms"  # (b): the leader held on the card while the 32 arrive
COALESCE_SLOW = "600ms"  # (b): the leader held past the short follower's budget
COALESCE_FOLLOWERS = 3
SHORT_TIMEOUT_S = "0.1"
DCT_PATH = "/resize?width=300&height=200"  # phase 9's /resize (k = 2 on large.jpg, k = 1 on 4K)
DCT_QUERY = {"width": "300", "height": "200"}
DEVICE_SERIAL = 5  # (d): the same request, one at a time
DEVICE_CLIENTS = 16  # (d) on four lanes: clients x 4 requests over four sources
DEVICE_SOURCES = (92, 87, 82, 77)  # JPEG qualities: four distinct 4:2:0 sources
EVICT_SOURCES = (91, 86, 81)  # (d): three 4K sources in turn, twice
EVICT_FRAMES = 2.5  # (d): the small budget in frames (two fit, three do not)
SOURCE_SERIAL = 5  # (f)
PHASE6_ANSWERS: list = []  # phase 6's answers alone, in CONFIG2_REQUESTS order


def cache_server(args: list, devices=None):
    """A phase 16 server from the port's command line (`cli.parse_args`)
    with --prewarm on DEVICE, mounted on tests/testdata; `devices` puts its
    lanes on the given entries (the command line names whole cards only):
    (server, stop). The device frame tier is process-wide, so servers
    that arm it run one at a time."""
    import dataclasses

    from imaginary_tpu_torch import cli
    from imaginary_tpu_torch.web import app as app_mod

    o = cli.options_from_args(cli.parse_args(
        ["--addr", "127.0.0.1", "--port", "0", "--device", DEVICE, "--log-level", "error",
         "--mount", TESTDATA, "--prewarm"] + CACHE_BATCHING + list(args)))
    if devices is not None:
        o = dataclasses.replace(o, devices=devices)
    srv = app_mod.AppServer(o, log_stream=app_mod._Discard())
    return srv, start(srv)


def lane_entries() -> list:
    return [f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE] * LANE_ENTRIES


def cache_block(srv) -> dict:
    return srv.service.health()["cache"]


def timed_get(port: int, path: str, headers=None, method: str = "GET", body=None):
    t0 = time.perf_counter()
    status, hdrs, out = http_get(port, path, headers, method, body)
    return status, hdrs, out, (time.perf_counter() - t0) * 1e3


def config1_launches_ok(launches: dict, n: int, what: str) -> None:
    for k in CONFIG1_KERNELS:
        if launches.get(k, 0) != n:
            raise AssertionError(f"{what}: {k} launched {launches.get(k, 0)} times, "
                                 f"expected {n}")


def result_tier_case(smi: str, want: dict, launches: dict) -> dict:
    """(a) CACHE_SERIAL config 1 GETs with --cache-result-mb 64: one miss,
    then hits that launch nothing, every answer byte-equal to the uncached
    server's with one ETag; If-None-Match answers 304 with ETag (and Vary
    on the negotiated form) and no body."""
    import numpy as np

    from imaginary_tpu_torch import kernels

    srv, stop = cache_server(["--cache-result-mb", "64"])
    try:
        port = srv.server_address[1]
        ex = srv.service.executor
        kernels.reset_launches()
        items0 = ex.stats.items
        answers, after_miss = [], None
        for i in range(CACHE_SERIAL):
            answers.append(timed_get(port, CONFIG1_GET))
            if i == 0:
                after_miss = (kernels.launch_counts(), ex.stats.items)
        got = kernels.launch_counts()
        items = ex.stats.items - items0
        etag = answers[0][1].get("ETag")
        bad = [i for i, (s, h, b, _) in enumerate(answers)
               if (s, b, h.get("ETag")) != (200, want["resize"], etag)]
        if bad or not etag:
            raise AssertionError(f"(a) answers {bad} differ from the uncached server's "
                                 f"(ETag {etag})")
        if got != after_miss[0] or items != 1:
            raise AssertionError(f"(a) hits launched: {after_miss[0]} -> {got}, "
                                 f"{items} executor items")
        config1_launches_ok(got, 1, "(a)")
        st = cache_block(srv)
        if (st["result_misses"], st["result_hits"]) != (1, CACHE_SERIAL - 1):
            raise AssertionError(f"(a) result tier {st}")
        s304, h304, b304 = http_get(port, CONFIG1_GET, {"If-None-Match": etag})
        neg = CONFIG1_GET + "&type=auto"
        sn, hn, bn = http_get(port, neg, {"Accept": "image/jpeg"})
        sv, hv, bv = http_get(port, neg, {"Accept": "image/jpeg",
                                          "If-None-Match": hn.get("ETag", "")})
        if (s304, b304, h304.get("ETag")) != (304, b"", etag):
            raise AssertionError(f"(a) conditional GET: {s304} {h304}")
        if (sn, bn, hn.get("Vary")) != (200, want["resize"], "Accept") or \
                (sv, bv, hv.get("ETag"), hv.get("Vary")) != (304, b"", hn["ETag"], "Accept"):
            raise AssertionError(f"(a) negotiated form: {sn} {hn}, then {sv} {hv}")
        add_launches(launches, kernels.launch_counts())
        st = cache_block(srv)
    finally:
        stop()
    miss_ms = answers[0][3]
    hit_p50 = float(np.percentile([a[3] for a in answers[1:]], 50))
    log(f"  (a) --cache-result-mb 64, {CACHE_SERIAL} config 1 GETs: 1 miss "
        f"({miss_ms:.2f} ms; uncached server p50 {want['resize_p50_ms']:.2f} ms), "
        f"{CACHE_SERIAL - 1} hits (p50 {hit_p50:.2f} ms, host clock), no launch after the "
        f"miss ({got}); every answer byte-equal to the uncached server's, ETag {etag}; "
        f"If-None-Match 304 (ETag; Vary: Accept on type=auto), etag_304 "
        f"{st['etag_304']}  [{smi}]")
    return {"miss_ms": miss_ms, "hit_p50_ms": hit_p50,
            "uncached_p50_ms": want["resize_p50_ms"], "launches": got, "etag": etag,
            "cache": st}


def coalesce_case(smi: str, want: dict, launches: dict) -> dict:
    """(b) --cache-coalesce: COALESCE_CLIENTS identical config 1 GETs at
    once (the leader held COALESCE_HOLD on the card so that every arrival
    lands inside its run): flight_executed 1-3, the rest coalesced, K1-K4
    launched at most once per executed group and at least once, every
    answer byte-equal. Then with --request-timeout 30 and the leader held
    COALESCE_SLOW: a follower whose X-Request-Timeout is SHORT_TIMEOUT_S
    answers 504 at stage queue, the others 200, and nothing stays owed."""
    from imaginary_tpu_torch import failpoints, kernels

    srv, stop = cache_server(["--cache-coalesce", "--request-timeout", "30",
                              "--cpus", str(COALESCE_CLIENTS)])
    try:
        port = srv.server_address[1]
        svc = srv.service
        ex = svc.executor
        http_get(port, CONFIG1_GET)  # the first request's card warm-up
        st0 = cache_block(srv)
        items0 = ex.stats.items
        kernels.reset_launches()
        failpoints.activate(f"device.slow=delay({COALESCE_HOLD})")
        try:
            wall, got = tolerant_load(port, [(CONFIG1_GET, None, {})], COALESCE_CLIENTS, 1)
        finally:
            failpoints.deactivate()
        ran = kernels.launch_counts()
        add_launches(launches, ran)
        st = cache_block(srv)
        executed = st["flight_executed"] - st0["flight_executed"]
        coalesced = st["flight_coalesced"] - st0["flight_coalesced"]
        items = ex.stats.items - items0
        bad = [r for r in got if (r[3], r[5]) != (200, want["resize"])]
        if bad:
            raise AssertionError(f"(b) {len(bad)} answers differ from the uncached server's")
        if not 1 <= executed <= 3 or executed + coalesced != COALESCE_CLIENTS \
                or items != executed:
            raise AssertionError(f"(b) executed {executed}, coalesced {coalesced}, "
                                 f"{items} executor items")
        for k in CONFIG1_KERNELS:
            if not 1 <= ran[k] <= executed:
                raise AssertionError(f"(b) {k} launched {ran[k]} times for {executed} "
                                     f"executed groups")
        # the deadline on the coalesce wait: the leader, then its
        # followers, then one whose own budget ends in the wait
        fine: list = []
        threads = [threading.Thread(target=lambda: fine.append(http_get(port, CONFIG1_GET)))
                   for _ in range(COALESCE_FOLLOWERS + 1)]
        failpoints.activate(f"device.slow=delay({COALESCE_SLOW})")
        try:
            threads[0].start()
            time.sleep(0.1)
            for th in threads[1:]:
                th.start()
            time.sleep(0.05)
            short = http_get(port, CONFIG1_GET, {"X-Request-Timeout": SHORT_TIMEOUT_S})
            for th in threads:
                th.join(timeout=60)
        finally:
            failpoints.deactivate()
        body = json.loads(short[2])
        timing = short[1].get("Server-Timing", "")
        if (short[0], body.get("stage")) != (504, "queue") or "coalesce_wait" not in timing:
            raise AssertionError(f"(b) the short follower answered {short[0]} {body}, "
                                 f"Server-Timing {timing}")
        if [a[0] for a in fine] != [200] * (COALESCE_FOLLOWERS + 1) \
                or any(a[2] != want["resize"] for a in fine):
            raise AssertionError(f"(b) the waiters answered {[a[0] for a in fine]}")
        at_rest = wait_for(lambda: (ex.stats.device_owed_mb, ex.stats.host_inflight,
                                    svc._inflight) == (0, 0, 0))
        e = ex.stats.to_dict()
        if not at_rest:
            raise AssertionError(f"(b) owed {e['device_owed_mb']} MB, host_inflight "
                                 f"{e['host_inflight']}, pool inflight {svc._inflight}")
        st2 = cache_block(srv)
    finally:
        stop()
    log(f"  (b) --cache-coalesce, {COALESCE_CLIENTS} identical config 1 GETs at once "
        f"({wall * 1e3:.1f} ms wall, leader held {COALESCE_HOLD}): flight_executed "
        f"{executed}, coalesced {coalesced}, {items} executor item(s), launches {ran}; "
        f"every answer byte-equal; a follower at X-Request-Timeout {SHORT_TIMEOUT_S} s "
        f"behind a leader held {COALESCE_SLOW}: 504 stage {body['stage']} "
        f"(budget_ms {body.get('budget_ms')}, coalesce_wait in its Server-Timing), "
        f"{len(fine)} others 200; device_owed_mb "
        f"{e['device_owed_mb']}, host_inflight {e['host_inflight']} at rest  [{smi}]")
    return {"executed": executed, "coalesced": coalesced, "items": items,
            "launches": ran, "wall_ms": wall * 1e3, "short": {"status": short[0], **body},
            "cache": st2}


def frame_tier_case(smi: str, want: dict, launches: dict) -> dict:
    """(c) --cache-frame-mb 64: /resize then /crop on large.jpg; the /crop
    decodes nothing (one decode in stageTimesMs), both byte-equal to the
    uncached server's."""
    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.engine.timing import TIMES

    srv, stop = cache_server(["--cache-frame-mb", "64"])
    try:
        port = srv.server_address[1]
        TIMES.reset()
        kernels.reset_launches()
        r1 = http_get(port, CONFIG1_GET)
        r2 = http_get(port, CROP_GET)
        ran = kernels.launch_counts()
        add_launches(launches, ran)
        stages = srv.service.health().get("stageTimesMs", {})
        st = cache_block(srv)
    finally:
        stop()
    decodes = stages.get("decode", {}).get("count", 0)
    if (r1[0], r1[2], r2[0], r2[2]) != (200, want["resize"], 200, want["crop"]):
        raise AssertionError("(c) answers differ from the uncached server's")
    if decodes != 1 or (st["frame_misses"], st["frame_hits"]) != (1, 1):
        raise AssertionError(f"(c) {decodes} decodes, frame tier {st}")
    config1_launches_ok(ran, 2, "(c)")
    log(f"  (c) --cache-frame-mb 64: /resize then /crop on large.jpg: frame misses "
        f"{st['frame_misses']}, hits {st['frame_hits']}, {decodes} decode in "
        f"stageTimesMs, {st['frame_bytes']} B resident; both byte-equal to the uncached "
        f"server's; launches {ran}  [{smi}]")
    return {"decodes": decodes, "launches": ran, "cache": st}


def reencoded(buf: bytes, quality: int) -> bytes:
    """buf as a 4:2:0 baseline JPEG at `quality` (Pillow): another source
    of the same geometry."""
    import io

    from PIL import Image

    out = io.BytesIO()
    Image.open(io.BytesIO(buf)).convert("RGB").save(out, "JPEG", quality=quality,
                                                    subsampling=2)
    return out.getvalue()


def rest_bytes(plan) -> int:
    """The bytes of a launch's h, w and dyns staged in its one H2D at B=1."""
    import numpy as np

    def aligned(n: int) -> int:
        return (n + 15) // 16 * 16

    return 2 * aligned(4) + sum(aligned(np.asarray(v).nbytes)
                                for st in plan.stages for v in st.dyn.values())


def post(port: int, path: str, body: bytes, headers=None):
    return http_get(port, path, {"Content-Type": "image/jpeg", **(headers or {})},
                    "POST", body)


DCT_FLAGS = ["--transport-dct", "--transport-dct-egress"]
DEVICE_TIER = ["--cache-frame-mb", "64", "--cache-device-mb", "256"]


def device_tier_case(smi: str, png: bytes, launches: dict) -> dict:
    """(d) and (e): the device frame tier on phase 9's /resize (see the
    module docstring)."""
    from imaginary_tpu_torch import kernels

    with open(LARGE_JPG, "rb") as f:
        large = f.read()
    sources = [reencoded(large, q) for q in DEVICE_SOURCES]
    jpeg_4k = make_4k_jpeg(png)
    big = [reencoded(jpeg_4k, q) for q in EVICT_SOURCES]
    wrapped, packed, _ = dct_request_plan(large, "resize", DCT_QUERY)
    rest = rest_bytes(wrapped)
    miss_h2d = (packed.nbytes + 15) // 16 * 16 + rest
    big_plan, big_packed, big_shrink = dct_request_plan(big[0], "resize", DCT_QUERY)
    # the tier-off answers
    off, stop = cache_server(DCT_FLAGS)
    try:
        port = off.server_address[1]
        want = {"large": post(port, DCT_PATH, large)[2]}
        want.update({i: post(port, DCT_PATH, s)[2] for i, s in enumerate(sources)})
        want.update({("4k", i): post(port, DCT_PATH, s)[2] for i, s in enumerate(big)})
    finally:
        stop()
    out: dict = {"rest_bytes": rest, "miss_h2d": miss_h2d}
    # (d) one at a time, then (e) the brownout on the same server
    srv, stop = cache_server(DCT_FLAGS + DEVICE_TIER + [
        "--cache-source-ttl", "60", "--pressure-rss-mb", "1000000"])
    try:
        port = srv.server_address[1]
        kernels.reset_launches()
        per: list = []
        for _ in range(DEVICE_SERIAL):
            w0 = srv.service.health()["executor"]["wire_bytes"]["h2d"]
            s, _, b = post(port, DCT_PATH, large)
            w1 = srv.service.health()["executor"]["wire_bytes"]["h2d"]
            if (s, b) != (200, want["large"]):
                raise AssertionError("(d) an answer differs from the tier-off server's")
            per.append((w1 - w0, cache_block(srv)["device_hits"]))
        ran = kernels.launch_counts()
        add_launches(launches, ran)
        st = cache_block(srv)
        if [p[0] for p in per] != [miss_h2d] + [rest] * (DEVICE_SERIAL - 1) \
                or [p[1] for p in per] != list(range(DEVICE_SERIAL)):
            raise AssertionError(f"(d) h2d bytes and device_hits a request {per}; "
                                 f"expected {miss_h2d} then {rest}")
        for k in ("from_dct", "to_dct", "resample"):
            if ran[k] != DEVICE_SERIAL:
                raise AssertionError(f"(d) {k} launched {ran[k]} times")
        frame_bytes = st["device_bytes"] // max(1, st["device_items"])
        out["serial"] = {"h2d_by_request": [p[0] for p in per], "launches": ran,
                         "device_bytes_a_frame": frame_bytes, "cache": st}
        log(f"  (d) --cache-device-mb 256, phase 9's {DCT_PATH} on large.jpg x "
            f"{DEVICE_SERIAL}: h2d {per[0][0]} B on the miss, then "
            f"{', '.join(str(p[0]) for p in per[1:])} B (h, w and the dyns: {rest} B); "
            f"device_hits {[p[1] for p in per]}; {frame_bytes} B resident a frame; every "
            f"answer bit-equal to the tier-off server's; launches {ran}  [{smi}]")
        out["brownout"] = brownout_case(smi, srv, large, want["large"], launches)
    finally:
        stop()
    out["lanes"] = device_lanes_case(smi, sources, want, launches)
    out["eviction"] = eviction_case(smi, big, want, big_packed.nbytes, launches)
    return out


def device_lanes_case(smi: str, sources: list, want: dict, launches: dict) -> dict:
    """(d) on four lanes of card 0 (phase 10's layout), DEVICE_CLIENTS
    concurrent clients over four sources: the lanes' affinity hits, the
    tier's hits, every answer bit-equal (trap 1: a frame staged on one
    lane's stream is read on another's)."""
    from imaginary_tpu_torch import kernels

    srv, stop = cache_server(DCT_FLAGS + DEVICE_TIER + ["--mesh-policy", "lanes",
                                                        "--cpus", str(DEVICE_CLIENTS)],
                             devices=lane_entries())
    try:
        port = srv.server_address[1]
        reqs = [(DCT_PATH, s, {"Content-Type": "image/jpeg"}) for s in sources]
        kernels.reset_launches()
        wall, got = tolerant_load(port, reqs, DEVICE_CLIENTS, 4)
        ran = kernels.launch_counts()
        add_launches(launches, ran)
        lanes = srv.service.executor.stats.to_dict()["lanes"]
        st = cache_block(srv)
    finally:
        stop()
    bad = [r for r in got if (r[3], r[5]) != (200, want[r[0]])]
    aff = sum(ln["affinity_hits"] for ln in lanes)
    if bad or aff <= 0 or st["device_hits"] <= 0:
        raise AssertionError(f"(d) lanes: {len(bad)} answers differ, affinity_hits {aff}, "
                             f"device_hits {st['device_hits']}")
    log(f"  (d) four lanes of card 0, {DEVICE_CLIENTS} clients x 4 over "
        f"{len(sources)} sources ({wall * 1e3:.1f} ms): affinity_hits "
        f"{[ln['affinity_hits'] for ln in lanes]}, dispatches "
        f"{[ln['dispatches'] for ln in lanes]}; device hits {st['device_hits']}, misses "
        f"{st['device_misses']}; every answer bit-equal to the tier-off server's  [{smi}]")
    return {"lanes": lanes, "launches": ran, "cache": st, "wall_ms": wall * 1e3}


def eviction_case(smi: str, big: list, want: dict, frame_bytes: int, launches: dict) -> dict:
    """(d) with a budget of EVICT_FRAMES 4K frames at k = 1, three sources
    in turn, twice: device_evictions > 0 and device_bytes within the
    budget; then the tier cleared and the card synchronised:
    torch.cuda.memory_allocated falls by at least the tier's bytes."""
    from imaginary_tpu_torch import kernels

    budget_mb = EVICT_FRAMES * frame_bytes / 1e6
    srv, stop = cache_server(DCT_FLAGS + ["--cache-frame-mb", "64",
                                          "--cache-device-mb", f"{budget_mb:.6f}"])
    try:
        port = srv.server_address[1]
        kernels.reset_launches()
        peak = 0
        for _ in range(2):
            for i, s in enumerate(big):
                st_, _, b = post(port, DCT_PATH, s)
                if (st_, b) != (200, want[("4k", i)]):
                    raise AssertionError("(d) a 4K answer differs from the tier-off server's")
                peak = max(peak, cache_block(srv)["device_bytes"])
        add_launches(launches, kernels.launch_counts())
        st = cache_block(srv)
        budget = srv.service.caches.device.budget
        if st["device_evictions"] <= 0 or peak > budget:
            raise AssertionError(f"(d) evictions {st['device_evictions']}, peak "
                                 f"{peak} B over the {budget} B budget")
        freed = tier_freed(srv)
    finally:
        stop()
    log(f"  (d) a budget of {EVICT_FRAMES} 4K frames at k = 1 ({budget} B, "
        f"{frame_bytes} B a frame), three sources in turn x 2: device_evictions "
        f"{st['device_evictions']}, misses {st['device_misses']}, peak {peak} B resident; "
        f"cleared: memory_allocated fell {freed['fell']} B for {freed['tier']} B "
        f"resident  [{smi}]")
    return {"budget": budget, "frame_bytes": frame_bytes, "peak": peak, "cache": st,
            "freed": freed}


def tier_freed(srv, clear=None) -> dict:
    """Drop the device tier's frames (`clear`, else DeviceFrameCache.clear),
    synchronise the card and read how far torch.cuda.memory_allocated
    fell; it must fall by at least the tier's bytes."""
    import torch

    tier = srv.service.caches.device.bytes_used
    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
    alloc = torch.cuda.memory_allocated if DEVICE == "cuda" else (lambda: tier)
    sync()
    before = alloc()
    (clear or srv.service._device_frames.clear)()
    sync()
    fell = before - (alloc() if DEVICE == "cuda" else 0)
    if tier <= 0 or fell < tier:
        raise AssertionError(f"memory_allocated fell {fell} B for {tier} B resident")
    return {"tier": tier, "fell": fell}


def brownout_case(smi: str, srv, large: bytes, want: bytes, launches: dict) -> dict:
    """(e) the memory.rss failpoint holds the governor at critical on (d)'s
    server: device and source budgets 0, result and frame a quarter,
    pressure_shrinks 1, the resident frames freed; back at ok the budgets
    are restored and the tier refills."""
    from imaginary_tpu_torch import kernels

    port = srv.server_address[1]
    caches = srv.service.caches
    base = {k: getattr(caches, k).budget for k in ("result", "frames", "device", "source")}
    kernels.reset_launches()
    if post(port, DCT_PATH, large)[2] != want:
        raise AssertionError("(e) the answer before the brownout differs")
    try:
        freed = tier_freed(srv, clear=lambda: arm_level(srv, "memory.rss=error"))
        level = srv.service.pressure.level_name()
        crit = {k: getattr(caches, k).budget for k in base}
        st = cache_block(srv)
        s, _, b = post(port, DCT_PATH, large)  # serves with the tier off
    finally:
        arm_level(srv, "")
    back = {k: getattr(caches, k).budget for k in base}
    refill = [post(port, DCT_PATH, large) for _ in range(2)]
    add_launches(launches, kernels.launch_counts())
    st2 = cache_block(srv)
    expect = {"result": base["result"] // 4, "frames": base["frames"] // 4,
              "device": 0, "source": 0}
    if level != "critical" or crit != expect or st["pressure_shrinks"] != 1 \
            or st["device_bytes"] != 0:
        raise AssertionError(f"(e) level {level}, budgets {crit} (expected {expect}), "
                             f"{st}")
    if (s, b) != (200, want) or back != base or any(r[2] != want for r in refill) \
            or st2["device_items"] != 1 or st2["device_hits"] <= st["device_hits"]:
        raise AssertionError(f"(e) after the brownout: budgets {back}, {st2}")
    log(f"  (e) memory.rss -> critical on (d)'s server: budgets {crit} (from {base}); "
        f"pressure_shrinks {st['pressure_shrinks']}; memory_allocated fell "
        f"{freed['fell']} B for {freed['tier']} B resident; served at critical with the "
        f"tier off; back at ok: budgets restored, the tier refilled "
        f"({st2['device_items']} frame, hits {st2['device_hits']})  [{smi}]")
    return {"base": base, "critical": crit, "freed": freed, "cache": st, "after": st2}


def source_tier_case(smi: str, want: dict, launches: dict) -> dict:
    """(f) config 1 over ?url= from a local origin with --cache-source-ttl
    60: SOURCE_SERIAL requests, each with its own X-Request-ID; the origin
    sees one GET, carrying the first request's X-Request-ID; source_hits
    SOURCE_SERIAL - 1; every answer byte-equal to the uncached server's."""
    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.web import app as app_mod

    with open(LARGE_JPG, "rb") as f:
        origin = Origin({"/large.jpg": f.read()})
    try:
        from imaginary_tpu_torch import cli

        o = cli.options_from_args(cli.parse_args(
            url_server_args(origin, DEVICE) + ["--prewarm", "--cache-source-ttl", "60"]
            + CACHE_BATCHING))
        srv = app_mod.AppServer(o, log_stream=app_mod._Discard())
        stop = start(srv)
        try:
            port = srv.server_address[1]
            path = f"/resize?width=300&height=200&url={origin.url}/large.jpg"
            kernels.reset_launches()
            got = [http_get(port, path, {"X-Request-ID": f"chip-smoke-f-{i}"})
                   for i in range(SOURCE_SERIAL)]
            ran = kernels.launch_counts()
            add_launches(launches, ran)
            st = cache_block(srv)
        finally:
            stop()
        gets = origin.gets("/large.jpg")
        seen = [h.get("X-Request-ID") for p, h in origin.seen if p == "/large.jpg"]
    finally:
        origin.close()
    if any((s, b) != (200, want["resize"]) for s, _, b in got):
        raise AssertionError("(f) an answer differs from the uncached server's")
    if gets != 1 or seen != ["chip-smoke-f-0"] or \
            (st["source_misses"], st["source_hits"]) != (1, SOURCE_SERIAL - 1):
        raise AssertionError(f"(f) origin GETs {gets} ({seen}), source tier {st}")
    config1_launches_ok(ran, SOURCE_SERIAL, "(f)")
    log(f"  (f) --cache-source-ttl 60, config 1 over ?url= x {SOURCE_SERIAL}: the origin "
        f"saw {gets} GET (X-Request-ID {seen[0]}), source_hits {st['source_hits']}, "
        f"{st['source_bytes']} B held; every answer byte-equal; launches {ran}  [{smi}]")
    return {"origin_gets": gets, "launches": ran, "cache": st}


def lanes_mix_case(smi: str, launches: dict) -> dict:
    """(g) phase 6's mix on four lanes of card 0: each lane fetcher
    resolves every chunk as its own event completes; every answer
    byte-equal to phase 6's."""
    bodies = {}
    for _, src, _ in CONFIG2_REQUESTS:
        with open(src, "rb") as f:
            bodies[src] = f.read()
    srv, stop = cache_server(["--mesh-policy", "lanes", "--cpus", str(CLIENTS)],
                             devices=lane_entries())
    try:
        got = serve_mix(srv, bodies, PHASE6_ANSWERS, windows=1)
    finally:
        stop()
    add_launches(launches, got["launches"])
    log(f"  (g) phase 6's mix on four lanes of card 0: {got['requests']} answers "
        f"byte-equal to phase 6's; {got['rps']:.1f} req/s, p99 {got['p99_ms']:.2f} ms  "
        f"[{smi}]")
    return {"rps": got["rps"], "p99_ms": got["p99_ms"], "launches": got["launches"]}


CROP_GET = "/crop?width=300&height=200&file=large.jpg"


def uncached_answers() -> dict:
    """Config 1's answers (and /crop's, and the p50 of CACHE_SERIAL GETs)
    from a server with every tier off."""
    import numpy as np

    srv, stop = cache_server([])
    try:
        port = srv.server_address[1]
        got = [timed_get(port, CONFIG1_GET) for _ in range(CACHE_SERIAL)]
        crop = http_get(port, CROP_GET)
    finally:
        stop()
    bodies = {g[2] for g in got}
    if len(bodies) != 1 or any(g[0] != 200 for g in got) or crop[0] != 200 \
            or "ETag" in got[0][1]:
        raise AssertionError("the uncached server's config 1 answers disagree")
    return {"resize": got[0][2], "crop": crop[2],
            "resize_p50_ms": float(np.percentile([g[3] for g in got], 50))}


def cache_phase(smi: str, png: bytes) -> dict:
    """Phase 16 (see the module docstring): (a)-(g); `launches` sums the
    kernel launches of the paths each case drives."""
    t0 = time.perf_counter()
    launches: dict = {}
    out: dict = {}
    seconds: dict = {}
    want = uncached_answers()
    for name, case in (("result", lambda: result_tier_case(smi, want, launches)),
                       ("coalesce", lambda: coalesce_case(smi, want, launches)),
                       ("frame", lambda: frame_tier_case(smi, want, launches)),
                       ("device", lambda: device_tier_case(smi, png, launches)),
                       ("source", lambda: source_tier_case(smi, want, launches)),
                       ("lanes", lambda: lanes_mix_case(smi, launches))):
        t = time.perf_counter()
        out[name] = case()
        seconds[name] = time.perf_counter() - t
    out["launches"] = {k: launches.get(k, 0) for k in KERNEL_ROWS}
    out["seconds"] = {"total": time.perf_counter() - t0, **seconds}
    log(f"  phase 16: {out['seconds']['total']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()) + ")")
    return out


# --- phase 17: the mesh: config 5 on the card, NCCL, two processes -----------

CONFIG5_N = 32
CONFIG5_SEED = 23
CONFIG5_PATH = "/resize?width=300"
CONFIG5_CLIENTS = 16
CONFIG5_PER_CLIENT = 3
CONFIG5_BATCHING = dict(max_batch=16, batch_form_ms=5.0, cpus=CONFIG5_CLIENTS)
# K2 -> K1 -> K3 on the JPEGs (yuv420 transport), K1 on the PNGs and WEBPs
CONFIG5_KERNELS = ("yuv420_unpack", "resample", "yuv420_pack")
MESH_HOST_BOOT_S = 240
CONFIG1_GET = "/resize?width=300&height=200&file=large.jpg"


def make_config5_stream() -> list:
    """bench_firehose.py:_gen_stream(32, seed=23), drawn and encoded with
    OpenCV as it does: [(bytes, extension)], JPEG, PNG and WEBP in turn at
    420-780 x 560-1100."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(CONFIG5_SEED)
    out = []
    for i in range(CONFIG5_N):
        h = int(rng.integers(420, 780))
        w = int(rng.integers(560, 1100))
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = np.stack([
            128 + 90 * np.sin(xx / (23 + (i % 7))),
            128 + 90 * np.cos(yy / (29 + (i % 5))),
            (xx + yy) % 255,
        ], axis=-1)
        cy, cx = int(h * (0.3 + 0.4 * rng.random())), int(w * (0.3 + 0.4 * rng.random()))
        r = int(min(h, w) * 0.12)
        cv2.circle(base, (cx, cy), r, (255, 255, 255), -1)
        cv2.circle(base, (cx, cy), r // 2, (0, 0, 0), -1)
        noise = rng.normal(0, 6, (h, w, 3))
        img = np.clip(base + noise, 0, 255).astype(np.uint8)
        fmt = (".jpg", ".png", ".webp")[i % 3]
        ok, buf = cv2.imencode(fmt, img)
        if not ok:
            raise AssertionError(f"cv2 could not encode {fmt}")
        out.append((buf.tobytes(), fmt))
    return out


def config5_run(label: str, srv, reqs: list, want, launches: dict) -> tuple:
    """Each request alone (the server's answers), then one window of
    CONFIG5_CLIENTS clients x CONFIG5_PER_CLIENT: req/s, mean batch,
    dispatches per entry, wire_bytes_by_device, every answer byte-equal to
    `want` (None: this server's alone answers become it). Returns (its
    numbers, the answers)."""
    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.engine.timing import WIRE

    port = srv.server_address[1]
    alone = []
    for path, body in reqs:
        status, ctype, out = http(port, path, body)
        if status != 200:
            raise AssertionError(f"{label}: config 5 alone {status} {ctype}")
        alone.append((ctype, out))
    if want is not None and alone != want:
        raise AssertionError(f"{label}: answers alone differ from the unsharded server's")
    want = alone
    ex = srv.service.executor
    items0, batches0, sharded0 = ex.stats.items, ex.stats.batches, ex.stats.sharded_batches
    lanes0 = [ln.dispatches for ln in ex._lanes.lanes] if ex._lanes is not None else None
    mesh0 = list(ex.stats.mesh_dispatches or [])
    kernels.reset_launches()
    WIRE.reset()
    wall, got = load_window(port, reqs, CONFIG5_CLIENTS, CONFIG5_PER_CLIENT)
    counts = kernels.launch_counts()
    wire = ex.stats.to_dict().get("wire_bytes_by_device")
    add_launches(launches, counts)
    for name in CONFIG5_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"{label}: kernel {name} was not launched on config 5")
    bad = [g for g in got if (g[2], (g[3], g[4])) != (200, want[g[0]])]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} of {len(got)} answers differ "
                             f"(first: request {bad[0][0]}, status {bad[0][2]})")
    items, batches = ex.stats.items - items0, ex.stats.batches - batches0
    if lanes0 is not None:
        per_entry = [ln.dispatches - d for ln, d in zip(ex._lanes.lanes, lanes0)]
    elif mesh0:
        per_entry = [a - b for a, b in zip(ex.stats.mesh_dispatches, mesh0)]
    else:
        per_entry = [batches]
    out = {"requests": len(got), "wall_s": wall, "rps": len(got) / wall, "items": items,
           "batches": batches, "mean_batch": items / max(1, batches),
           "dispatches_per_entry": per_entry,
           "sharded_batches": ex.stats.sharded_batches - sharded0,
           "wire_bytes_by_device": wire,
           "launches": counts, "byte_equal": len(got)}
    log(f"  {label}: {out['rps']:.1f} req/s ({len(got)} requests in {wall:.2f} s), "
        f"{items} items in {batches} batches (mean {out['mean_batch']:.2f}), "
        f"dispatches per entry {per_entry}, sharded {out['sharded_batches']}, "
        f"wire_bytes_by_device {out['wire_bytes_by_device']}; byte-equal")
    return out, want


def nccl_case() -> dict:
    """(b) init_distributed on cuda:0 with a world of one, then one
    all_reduce of a CUDA tensor through `psum`."""
    import torch

    from imaginary_tpu_torch.parallel import mesh as mesh_mod

    t0 = time.perf_counter()
    backend = mesh_mod.init_distributed(coordinator_address=f"127.0.0.1:{free_port()}",
                                        num_processes=1, process_id=0, device=DEVICE)
    init_s = time.perf_counter() - t0
    x = torch.arange(1, 9, dtype=torch.float32, device=DEVICE)
    t0 = time.perf_counter()
    y = mesh_mod.psum(x)
    torch.cuda.synchronize()
    reduce_s = time.perf_counter() - t0
    if backend != ("nccl" if DEVICE == "cuda" else "gloo"):
        raise AssertionError(f"init_distributed chose {backend}")
    mesh_mod.shutdown_distributed()
    if y.device != x.device or float(y.sum()) != 36.0 or not torch.equal(y, x):
        raise AssertionError(f"all_reduce of 1..8 over one rank gave {y.tolist()}")
    log(f"  NCCL, world 1: backend {backend}, init {init_s:.3f} s, all_reduce of "
        f"1..8 on {y.device} sums to {float(y.sum()):.1f} ({reduce_s * 1e3:.2f} ms, "
        f"the first collective builds the communicator)")
    return {"backend": backend, "init_s": init_s, "first_all_reduce_s": reduce_s,
            "sum": float(y.sum())}


def mesh_hosts_case() -> dict:
    """(c) Two `python -m imaginary_tpu_torch --mesh-hosts 2` processes on
    card 0 meet at boot (no collective: NCCL refuses two ranks on one card
    when it builds a communicator), then each answers config 1 byte-equal
    to the other and to phase 4."""
    coord = f"127.0.0.1:{free_port()}"
    booted: dict = {}

    def boot(pid: int) -> None:
        # both at once: process 0's rendezvous waits for process 1
        try:
            booted[pid] = ServerProcess(f"mesh_host{pid}", [
                "--mesh-hosts", "2", "--coordinator-address", coord,
                "--process-id", str(pid)])
        except Exception as e:  # re-raised below, in the main thread
            booted[pid] = e

    threads = [threading.Thread(target=boot, args=(pid,)) for pid in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    hosts = [h for h in booted.values() if isinstance(h, ServerProcess)]
    out = {}
    try:
        for h in booted.values():
            if isinstance(h, Exception):
                raise h
        hosts = [booted[0], booted[1]]
        answers = []
        for h in hosts:
            status, ctype, body = http(h.port, CONFIG1_GET, None)
            status, ctype, body = http(h.port, CONFIG1_GET, None)
            if (status, ctype) != (200, "image/jpeg"):
                raise AssertionError(f"{h.name}: config 1 {status} {ctype}")
            answers.append(body)
        if answers[0] != answers[1]:
            raise AssertionError("the two mesh hosts' config 1 answers differ")
        want = PHASE4_ANSWERS.get("resize")
        if want is not None and answers[0] != want:
            raise AssertionError("the mesh hosts' config 1 answer differs from phase 4's")
        out = {"boot_s": [h.boot_s for h in hosts],
               "sha256": hashlib.sha256(answers[0]).hexdigest(),
               "equal_to_phase4": want is not None}
    finally:
        for h in hosts:
            h.stop()
    log(f"  --mesh-hosts 2 on card 0: boots {out['boot_s'][0]:.2f} s and "
        f"{out['boot_s'][1]:.2f} s, config 1 byte-equal across both and to phase 4")
    return out


def mesh_phase() -> dict:
    """Phase 17 (see the module docstring): (a) config 5 on three servers
    (--use-mesh over four entries of card 0, --mesh-policy sharded over the
    same, unsharded), `launches` summing their windows; (b) NCCL with a
    world of one; (c) two --mesh-hosts processes."""
    import torch

    from imaginary_tpu_torch.web.app import make_server

    t0 = time.perf_counter()
    stream = make_config5_stream()
    reqs = [(CONFIG5_PATH, body) for body, _ in stream]
    log(f"  config 5's stream: {len(stream)} images, "
        f"{sum(len(b) for b, _ in stream)} bytes, made in {time.perf_counter() - t0:.2f} s")
    entries = [torch.device(DEVICE, 0) if DEVICE == "cuda" else torch.device(DEVICE)]
    entries = entries * LANE_ENTRIES
    launches: dict = {}
    out: dict = {}
    want = None
    for label, kw in (("unsharded", {}),
                      ("--use-mesh", dict(use_mesh=True, devices=entries)),
                      ("--mesh-policy sharded", dict(mesh_policy="sharded", devices=entries,
                                                     shard_min_items=LANE_SHARD_MIN))):
        srv = make_server("127.0.0.1", 0, device=DEVICE, **CONFIG5_BATCHING, **kw)

        def run(srv, label=label):
            return config5_run(f"{label} ({LANE_ENTRIES if 'devices' in kw else 1} "
                               f"entr{'ies' if 'devices' in kw else 'y'})",
                               srv, reqs, want, launches)

        out[label], want = serving(srv, run)
    if out["--use-mesh"]["sharded_batches"] <= 0:
        raise AssertionError("--use-mesh split no chunk over the mesh")
    wire = out["--use-mesh"]["wire_bytes_by_device"] or {}
    if DEVICE == "cuda" and set(wire.get("h2d", {})) != {"cuda:0"}:
        raise AssertionError(f"--use-mesh on card 0 booked wire bytes under {wire}")
    out["launches"] = launches
    out["nccl"] = nccl_case()
    out["mesh_hosts"] = mesh_hosts_case()
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 17: {out['seconds']:.1f} s; one card, so no cross-card copy ran")
    return out


# --- phase 18: SVG, PDF, HEIF and AVIF on the card ----------------------------

VECTOR_BOMB_MB = 65  # past pdf_mini's 64 MB inflate budget


def crafted_pdf(content: bytes, flate: bool = False, length=None) -> bytes:
    """A classic-xref one-page PDF (240x160) around `content`; `length`
    replaces the stream's /Length value."""
    import zlib

    data = zlib.compress(content) if flate else content
    extra = b" /Filter /FlateDecode" if flate else b""
    length = str(len(data)).encode() if length is None else length
    objs = [b"<< /Type /Catalog /Pages 2 0 R >>",
            b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
            b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 240 160] /Contents 4 0 R >>",
            b"<< /Length " + length + extra + b" >>\nstream\n" + data + b"\nendstream"]
    out = bytearray(b"%PDF-1.4\n")
    offsets = []
    for i, body in enumerate(objs, start=1):
        offsets.append(len(out))
        out += str(i).encode() + b" 0 obj\n" + body + b"\nendobj\n"
    xref_at = len(out)
    out += b"xref\n0 " + str(len(objs) + 1).encode() + b"\n0000000000 65535 f \n"
    for off in offsets:
        out += ("%010d 00000 n \n" % off).encode()
    out += (b"trailer\n<< /Size " + str(len(objs) + 1).encode() + b" /Root 1 0 R >>\n"
            b"startxref\n" + str(xref_at).encode() + b"\n%%EOF\n")
    return bytes(out)


def vector_loaders() -> dict:
    from PIL import features

    from imaginary_tpu_torch.codecs import vector_backend as vb

    return {"librsvg": vb.svg_available(), "poppler": vb.pdf_available(),
            "libheif": vb.heif_available(), "hevc_encoder": vb.heif_encode_available("hevc"),
            "av1_encoder": vb.heif_encode_available("av1"),
            "pillow_avif": bool(features.check("avif"))}


def vector_rules(have: dict) -> list:
    """(name, path, body, allowed answers): each answer the reference's rule
    for the loaders found, as (status, content type, (w, h) or JSON dims or
    None). A /resize wider than the source embeds (K4) and a narrower one
    resamples (K1; the SVG renders into the 1/N box first). HEIF and AVIF
    sources are refused by the handler's media gate (406, whatever the
    loaders); a failed AVIF or HEIF encode answers JPEG."""
    svg = have["librsvg"]
    avif_enc = have["pillow_avif"] or have["av1_encoder"]
    bomb = crafted_pdf(b" " * (VECTOR_BOMB_MB << 20), flate=True)
    circular = crafted_pdf(b"0 0 1 rg 10 10 50 50 re f", length=b"4 0 R")
    poppler = [(200, "image/jpeg", (100, 67))] if have["poppler"] else []
    return [
        ("svg", "/resize?width=300&file=button.svg", None,
         [(200, "image/jpeg", (300, 160))] if svg else [(406, "application/json", None)]),
        ("svg-down", "/resize?width=60&file=button.svg", None,
         [(200, "image/jpeg", (60, 40))] if svg else [(406, "application/json", None)]),
        ("svg-info", "/info?file=button.svg", None,
         [(200, "application/json", (240, 160) if svg else (0, 0))]),
        ("pdf", "/resize?width=300&file=page.pdf", None, [(200, "image/jpeg", (300, 160))]),
        ("pdf-down", "/resize?width=120&file=page.pdf", None, [(200, "image/jpeg", (120, 80))]),
        ("pdf-info", "/info?file=page.pdf", None, [(200, "application/json", (240, 160))]),
        ("avif", "/resize?width=300&file=test.avif", None, [(406, "application/json", None)]),
        ("avif-info", "/info?file=test.avif", None, [(406, "application/json", None)]),
        ("to-avif", "/resize?width=300&type=avif&file=large.jpg", None,
         [(200, "image/avif" if avif_enc else "image/jpeg", (300, 169))]),
        ("to-heif", "/resize?width=300&type=heif&file=large.jpg", None,
         [(200, "image/heif" if have["hevc_encoder"] else "image/jpeg", (300, 169))]),
        ("pdf-bomb", "/resize?width=100", bomb,
         poppler + [(400, "application/json", None)] if have["poppler"]
         else [(406, "application/json", None)]),
        ("pdf-circular", "/resize?width=100", circular,
         poppler + [(400, "application/json", None)] if have["poppler"]
         else [(406, "application/json", None)]),
    ]


def answer_dims(ctype: str, body: bytes):
    import io

    from PIL import Image

    from imaginary_tpu_torch.codecs import vector_backend as vb

    if ctype == "application/json":
        got = json.loads(body)
        return (got["width"], got["height"]) if "width" in got else None
    if ctype == "image/heif":
        w, h, _ = vb.heif_size(body)
        return w, h
    return Image.open(io.BytesIO(body)).size


def vector_phase() -> dict:
    """Phase 18 (see the module docstring): the loaders the machine has, then
    each vector route against the reference's rule for them, K1's launches
    (the SVG's RGBA frame takes its C = 4 form)."""
    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.web.app import make_server

    t0 = time.perf_counter()
    have = vector_loaders()
    log("  loaders: " + ", ".join(f"{k} {'yes' if v else 'no'}" for k, v in have.items()))
    rules = vector_rules(have)
    channels: list = []
    resample = kernels.resample

    def spy(x, *a, **k):
        channels.append(int(x.shape[-1]))
        return resample(x, *a, **k)

    srv = make_server("127.0.0.1", 0, device=DEVICE, mount=TESTDATA)

    def run(srv):
        port = srv.server_address[1]
        answers = {}
        kernels.reset_launches()
        kernels.resample = spy
        try:
            for name, path, body, allowed in rules:
                channels.clear()
                status, headers, out = http_get(
                    port, path, body=body,
                    headers={"Content-Type": "application/pdf"} if body else None,
                    method="POST" if body else "GET")
                ctype = headers.get("Content-Type")
                dims = answer_dims(ctype, out) if status == 200 else None
                if (status, ctype, dims) not in allowed:
                    raise AssertionError(f"{name}: {status} {ctype} {dims}, the reference's "
                                         f"rule allows {allowed}: {out[:200]!r}")
                answers[name] = {"status": status, "type": ctype, "dims": dims,
                                 "k1_channels": sorted(set(channels))}
                log(f"  {name}: {status} {ctype} {dims}; K1 launches at C = "
                    f"{answers[name]['k1_channels']}")
        finally:
            kernels.resample = resample
        return answers, kernels.launch_counts()

    answers, launches = serving(srv, run)
    if have["librsvg"] and answers["svg-down"]["k1_channels"] != [4]:
        raise AssertionError("the rasterized SVG's K1 launch was not the C = 4 form")
    if launches["resample"] <= 0:
        raise AssertionError("K1 was not launched on the vector routes")
    seconds = time.perf_counter() - t0
    log(f"  launches: {launches}; phase 18: {seconds:.1f} s")
    return {"loaders": have, "answers": answers, "launches": launches, "seconds": seconds}


# --- phase 19: the observability planes on the card -------------------------

OBS_SLO = '{"*": {"latency_ms": 250, "latency_target": 0.99, "availability": 0.999}}'
OBS_PLANES = ["--wide-events", "--wide-events-sample", "1.0", "--slo-config", OBS_SLO,
              "--enable-debug", "--cost-attribution"]
OBS_SERIAL = 20  # (a): config 1, one request at a time
OBS_PROFILE_S = 2.0  # (b): the capture's seconds
OBS_LATENCY_N = 25  # (c): requests a block; blocks armed, off, off, armed
OBS_TRICKLE = 8  # (e): chunks of the flowing slow body, OBS_TRICKLE_GAP_S apart
OBS_TRICKLE_GAP_S = 0.3
# (f): the spec a server arms from IMAGINARY_TPU_FAILPOINTS (an error at
# p = 1 and a keyed delay on card 0's launches) and one its boot refuses
FAILPOINT_ENV_SPEC = "codec.encode=error;device.slow[0]=delay(1ms)"
FAILPOINT_BAD_SPEC = "nope=error"
# the reference app's message for the armed error (tests/test_torch_deadline.py
# holds the port's answer equal to it)
FAILPOINT_ENV_ANSWER = "Error processing image: failpoint codec.encode: injected error"
FAILPOINT_BOOT_S = 120  # (f): the bad boot's limit
CONFIG1_PATH = "/resize?width=300&height=200"
# config 1's kernels by the symbol each source defines (kernels/csrc/*.cu)
CONFIG1_SYMBOLS = {"yuv420_unpack": "yuv420_to_rgb", "resample": "resample_tiles",
                   "gather": "gather_rows", "yuv420_pack": "rgb_to_yuv420"}
OBS_FAMILIES = ("imaginary_tpu_slo_burn_rate", "imaginary_tpu_slo_error_budget_remaining",
                "imaginary_tpu_cost_device_ms_total", "imaginary_tpu_cost_requests_total",
                "imaginary_tpu_utilization_chip_busy", "imaginary_tpu_utilization_lane_busy",
                "imaginary_tpu_utilization_wait_ms_total", "imaginary_tpu_event_loop_lag_seconds",
                "imaginary_tpu_event_loop_lag_last_seconds")
INFRA_ROUTES = ("/health", "/metrics", "/topz", "/debugz", "/debugz/profile")


class LineSink:
    """A thread-safe text stream: a server's access log and wide events."""

    def __init__(self):
        self._lock = threading.Lock()
        self._parts: list = []

    def write(self, s: str) -> None:
        with self._lock:
            self._parts.append(s)

    def events(self) -> list:
        with self._lock:
            text = "".join(self._parts)
        return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def obs_server(args: list, log_stream=None):
    """A phase 19 server from the port's command line on DEVICE, mounted on
    tests/testdata, with config 2's batching: (server, stop)."""
    from imaginary_tpu_torch import cli
    from imaginary_tpu_torch.web import app as app_mod

    o = cli.options_from_args(cli.parse_args(
        ["--addr", "127.0.0.1", "--port", "0", "--device", DEVICE, "--log-level", "error",
         "--mount", TESTDATA, "--max-batch", str(CONFIG2_MAX_BATCH),
         "--batch-form-ms", str(CONFIG2_FORM_MS)] + list(args)))
    srv = app_mod.AppServer(o, log_stream=log_stream if log_stream is not None
                            else app_mod._Discard())
    return srv, start(srv)


def get_json(port: int, path: str) -> dict:
    status, _, body = http_get(port, path)
    if status != 200:
        raise AssertionError(f"{path}: {status} {body[:200]!r}")
    return json.loads(body)


def config1_answer(port: int, buf: bytes, what: str) -> float:
    """One config 1 request; its answer byte-equal to phase 4's. Returns ms."""
    t0 = time.perf_counter()
    status, ctype, body = http(port, CONFIG1_PATH, buf)
    ms = (time.perf_counter() - t0) * 1e3
    if (status, ctype) != (200, "image/jpeg") or body != PHASE4_ANSWERS["resize"]:
        raise AssertionError(f"{what}: {status} {ctype}, {len(body)} B, not phase 4's answer")
    return ms


def obs_surfaces_case(srv, sink: LineSink, bodies: dict, launches: dict, smi: str) -> dict:
    """(a) OBS_SERIAL config 1 requests one at a time, then one window of
    phase 6's mix, on the armed server: every answer byte-equal to phases 4
    and 6; one wide event a request, each placed on the device with a
    device cost; /health's slo, capacity (its utilization over the mix's
    window) and eventLoop; /topz; /metrics' new families."""
    from imaginary_tpu_torch import kernels

    port = srv.server_address[1]
    buf = bodies[LARGE_JPG]
    config1_answer(port, buf, "(a) warm")
    kernels.reset_launches()
    for i in range(OBS_SERIAL):
        config1_answer(port, buf, f"(a) config 1 #{i}")
    ran = kernels.launch_counts()
    config1_launches_ok(ran, OBS_SERIAL, "(a)")
    add_launches(launches, ran)
    reqs = [(path, bodies[src]) for path, src, _ in CONFIG2_REQUESTS]
    for path, body in reqs:  # warm each route
        http(port, path, body)
    get_json(port, "/health")  # opens the utilization window over the mix
    kernels.reset_launches()
    wall, results = load_window(port, reqs, CLIENTS, PER_CLIENT)
    ran = kernels.launch_counts()
    add_launches(launches, ran)
    health = get_json(port, "/health")
    wrong = [r for r in results if (r[2], r[3], r[4]) != (200, "image/jpeg", PHASE6_ANSWERS[r[0]])]
    if wrong:
        raise AssertionError(f"(a) {len(wrong)} of {len(results)} mix answers differ from "
                             f"phase 6's (first {CONFIG2_REQUESTS[wrong[0][0]][0]})")
    for name in CONFIG2_KERNELS:
        if ran[name] <= 0:
            raise AssertionError(f"(a) kernel {name} was not launched by the mix")
    mix = {"requests": len(results), "rps": len(results) / wall,
           "p50_ms": statistics.median(r[1] for r in results),
           "p99_ms": sorted(r[1] for r in results)[int(0.99 * (len(results) - 1))]}
    for block in ("slo", "capacity", "eventLoop"):
        if block not in health:
            raise AssertionError(f"(a) /health has no {block} block")
    cap = health["capacity"]
    util, advice = cap["utilization"], cap["bound_by"]
    for key in ("chip_busy", "lanes", "wait_split_ms"):
        if key not in util:
            raise AssertionError(f"(a) capacity.utilization has no {key}: {util}")
    if "device_ms_per_mb" not in advice or advice["verdict"] == "unknown":
        raise AssertionError(f"(a) the advisor read no EWMA or no traffic: {advice}")
    topz = get_json(port, "/topz")
    status, _, text = http_get(port, "/metrics")
    families = {ln.split()[2] for ln in text.decode().splitlines() if ln.startswith("# TYPE ")}
    missing = [f for f in OBS_FAMILIES if f not in families]
    if status != 200 or missing:
        raise AssertionError(f"(a) /metrics {status}, missing {missing}")
    sent = 1 + OBS_SERIAL + len(CONFIG2_REQUESTS) + CLIENTS * PER_CLIENT
    image = [e for e in sink.events() if e["route"] not in INFRA_ROUTES]
    if len(image) != sent:
        raise AssertionError(f"(a) {len(image)} wide events for {sent} image requests")
    bad = [e for e in image if e["status"] != 200 or e.get("placement") != "device"
           or not e.get("cost_device_ms", 0.0) > 0.0]
    if bad:
        raise AssertionError(f"(a) {len(bad)} events off the device or without a device "
                             f"cost, first {json.dumps(bad[0])[:400]}")
    serial = [e for e in image if e["path"] == CONFIG1_PATH][1:1 + OBS_SERIAL]
    plane_ms = statistics.mean(e["cost_device_ms"] for e in serial)
    log(f"  (a) config 1 x {OBS_SERIAL} and phase 6's mix ({mix['requests']} answers, "
        f"{mix['rps']:.1f} req/s): every answer byte-equal to phases 4 and 6; {len(image)} "
        f"wide events, all placement device with cost_device_ms > 0")
    log(f"      config 1's cost_device_ms (the drain's wall share): mean {plane_ms:.4f} ms "
        f"over {len(serial)} serial requests")
    log(f"      capacity: chip_busy {util['chip_busy']}, lanes {util['lanes']}, link "
        f"{util.get('link')}, wait_split_ms {util['wait_split_ms']}")
    log(f"      bound_by {advice['verdict']}: " + ", ".join(
        f"{k} {advice[k]}" for k in ("device_ms_per_mb", "drain_floor_ms", "device_ms_per_req",
                                     "host_ms_per_req", "wire_mb_per_req", "host_workers",
                                     "link_rate", "chip_rate", "host_codecs_rate")
        if k in advice) + f"  [{smi}]")
    log(f"      slo routes {sorted(health['slo']['routes'])}, eventLoop {health['eventLoop']}, "
        f"/topz windows {sorted(topz['windows'])}")
    return {"events": len(image), "config1_cost_device_ms": plane_ms, "mix": {
        k: mix[k] for k in ("requests", "rps", "p50_ms", "p99_ms")},
        "utilization": util, "bound_by": advice, "slo": health["slo"],
        "eventLoop": health["eventLoop"], "topz_5m": topz["windows"].get("5m")}


def trace_device_time(path: str) -> tuple:
    """({kernel name: summed device ms}, copy and memset ms) of an exported
    Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels_ms: dict = {}
    copies_ms = 0.0
    for e in events:
        cat = e.get("cat", "")
        if cat == "kernel":
            kernels_ms[e["name"]] = kernels_ms.get(e["name"], 0.0) + e.get("dur", 0.0) / 1e3
        elif cat in ("gpu_memcpy", "gpu_memset"):
            copies_ms += e.get("dur", 0.0) / 1e3
    return kernels_ms, copies_ms


def obs_profile_case(srv, buf: bytes, launches: dict, smi: str) -> dict:
    """(b) /debugz/profile?seconds=OBS_PROFILE_S on the live armed server
    while config 1 runs one request at a time: the trace holds a kernel
    event for each of K2, K1, K4 and K3, by the symbols their sources
    define; a second capture meanwhile answers 409."""
    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.engine import timing

    port = srv.server_address[1]
    trace_dir = os.path.join(OUT_DIR, "obs_profile")
    os.makedirs(trace_dir, exist_ok=True)
    stop_load = threading.Event()
    done: list = []
    errors: list = []

    def load():
        try:
            while not stop_load.is_set():
                t0 = time.perf_counter()
                config1_answer(port, buf, "(b) config 1 under the capture")
                done.append((t0, time.perf_counter()))
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)

    kernels.reset_launches()
    loader = threading.Thread(target=load)
    loader.start()
    first: dict = {}
    query = urllib.parse.urlencode({"seconds": OBS_PROFILE_S, "dir": trace_dir})
    capture = threading.Thread(target=lambda: first.update(
        answer=http_get(port, f"/debugz/profile?{query}")))
    try:
        time.sleep(0.2)
        capture.start()
        t_end = time.perf_counter() + 10.0
        while not timing.profiler_active() and time.perf_counter() < t_end:
            time.sleep(0.005)
        t_active = time.perf_counter()
        second = http_get(port, "/debugz/profile?" + urllib.parse.urlencode(
            {"seconds": 0.05, "dir": trace_dir + "-second"}))
        capture.join()
    finally:
        stop_load.set()
        loader.join()
    add_launches(launches, kernels.launch_counts())
    if errors:
        raise errors[0]
    if second[0] != 409:
        raise AssertionError(f"(b) a second capture answered {second[0]}, not 409")
    status, _, body = first["answer"]
    if status != 200:
        raise AssertionError(f"(b) /debugz/profile answered {status}: {body[:300]!r}")
    got = json.loads(body)
    if got.get("activities") != (["cpu", "cuda"] if DEVICE.startswith("cuda") else ["cpu"]):
        raise AssertionError(f"(b) the capture did not record the card: {got}")
    size = os.path.getsize(got["trace_file"])
    by_name, copies_ms = trace_device_time(got["trace_file"])
    os.remove(got["trace_file"])  # megabytes; the summary is kept
    found = {k: sum(ms for name, ms in by_name.items() if sym in name)
             for k, sym in CONFIG1_SYMBOLS.items()}
    missing = [k for k, ms in found.items() if ms <= 0.0]
    if missing:
        raise AssertionError(f"(b) no kernel event of {missing} in the trace; kernels "
                             f"seen: {sorted(by_name)[:20]}")
    window = [d for d in done if d[0] >= t_active and d[1] <= t_active + OBS_PROFILE_S]
    card_ms = sum(by_name.values()) + copies_ms
    per_req = card_ms / max(1, len(window))
    log(f"  (b) /debugz/profile?seconds={OBS_PROFILE_S}: 200, a {size} B Chrome trace with "
        f"{got['device_events']} card events; a second capture meanwhile: 409")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1]):
        log(f"      {ms:9.3f} ms  {name[:100]}")
    log(f"      copies and memsets {copies_ms:.3f} ms; {len(window)} config 1 requests wholly "
        f"inside the window: {per_req:.4f} ms of card time a request (profiler)  [{smi}]")
    return {"trace_bytes": size, "device_events": got["device_events"],
            "kernel_ms": by_name, "copies_ms": copies_ms, "config1_found_ms": found,
            "requests_in_window": len(window), "card_ms_per_request": per_req}


def obs_latency_case(armed, off, buf: bytes, launches: dict, smi: str) -> dict:
    """(c) config 1's latency with every plane armed against a server with
    none, in turns (armed, off, off, armed), OBS_LATENCY_N serial requests
    a block; then the gates of the off server answer 404."""
    import numpy as np

    from imaginary_tpu_torch import kernels

    a_port, o_port = armed.server_address[1], off.server_address[1]
    for _ in range(3):
        config1_answer(o_port, buf, "(c) warm off")
    kernels.reset_launches()
    lat: dict = {"armed": [], "off": []}
    for name, port in (("armed", a_port), ("off", o_port), ("off", o_port),
                       ("armed", a_port)):
        for _ in range(OBS_LATENCY_N):
            lat[name].append(config1_answer(port, buf, f"(c) {name}"))
    ran = kernels.launch_counts()
    config1_launches_ok(ran, 4 * OBS_LATENCY_N, "(c)")
    add_launches(launches, ran)
    gates = {path: http_get(o_port, path)[0] for path in
             ("/debugz", "/debugz/profile?seconds=1", "/debugz/failpoints", "/topz")}
    if set(gates.values()) != {404}:
        raise AssertionError(f"(c) the off server's gates answered {gates}")
    out = {k: {"p50_ms": float(np.percentile(v, 50)), "p99_ms": float(np.percentile(v, 99)),
               "n": len(v)} for k, v in lat.items()}
    ratio = out["armed"]["p50_ms"] / out["off"]["p50_ms"]
    log(f"  (c) config 1, {2 * OBS_LATENCY_N} requests a server in turns: armed p50 "
        f"{out['armed']['p50_ms']:.3f} ms p99 {out['armed']['p99_ms']:.3f} ms; off p50 "
        f"{out['off']['p50_ms']:.3f} ms p99 {out['off']['p99_ms']:.3f} ms; p50 ratio "
        f"{ratio:.4f}  [{smi}]")
    log("      the off server's /debugz, /debugz/profile, /debugz/failpoints and /topz: 404")
    out["p50_ratio"] = ratio
    return out


def obs_h2_case(buf: bytes, launches: dict, smi: str) -> dict:
    """(d) TLS on a self-signed certificate: whether libnghttp2 loads; with
    it, curl with HTTP/2 and openssl, config 1 over h2 and over HTTP/1.1 on
    the same port, both byte-equal to phase 4's answer."""
    import shutil

    from imaginary_tpu_torch import kernels
    from imaginary_tpu_torch.web.http2 import load_nghttp2

    lib = load_nghttp2()
    curl = shutil.which("curl")
    curl_h2 = bool(curl) and any(
        t in subprocess.run([curl, "-V"], capture_output=True).stdout
        for t in (b"HTTP2", b"nghttp2"))
    openssl = shutil.which("openssl")
    why = [w for w, ok in (("libnghttp2 does not load", lib is not None),
                           ("no curl with HTTP/2", curl_h2),
                           ("no openssl for the certificate", bool(openssl))) if not ok]
    if why:
        log(f"  (d) h2 not driven: {'; '.join(why)} (ALPN offers http/1.1 alone without "
            f"the library)")
        return {"libnghttp2": lib is not None, "curl_h2": curl_h2, "driven": False, "why": why}
    tls = os.path.join(OUT_DIR, "obs_tls")
    os.makedirs(tls, exist_ok=True)
    cert, key = os.path.join(tls, "cert.pem"), os.path.join(tls, "key.pem")
    subprocess.run([openssl, "req", "-x509", "-newkey", "rsa:2048", "-keyout", key, "-out",
                    cert, "-days", "1", "-nodes", "-subj", "/CN=localhost"],
                   check=True, capture_output=True)
    srv, stop = obs_server(["--certfile", cert, "--keyfile", key])
    kernels.reset_launches()
    got = {}
    try:
        srv._ready.wait(30)
        if srv.listener is None or srv.listener.h2_server is None:
            raise AssertionError("(d) the TLS server runs no h2 terminator")
        url = f"https://127.0.0.1:{srv.server_address[1]}{CONFIG1_PATH}"
        for flag, want in (("--http1.1", "1.1"), ("--http2", "2")):
            out = os.path.join(tls, f"answer-{want}.jpg")
            r = subprocess.run([curl, "-sk", flag, "-o", out, "-w",
                                "%{http_version} %{http_code}", "-H",
                                "Content-Type: image/jpeg", "--data-binary",
                                f"@{LARGE_JPG}", url], capture_output=True, timeout=60)
            with open(out, "rb") as f:
                got[want] = (r.stdout.decode().split(), f.read())
    finally:
        stop()
    add_launches(launches, kernels.launch_counts())
    for want, (line, body) in got.items():
        if line != [want, "200"] or body != PHASE4_ANSWERS["resize"]:
            raise AssertionError(f"(d) HTTP/{want}: {line}, {len(body)} B, not phase 4's answer")
    log("  (d) libnghttp2 loads; config 1 over h2 and over HTTP/1.1 on one TLS port: both "
        "200, byte-equal to each other and to phase 4's answer")
    return {"libnghttp2": True, "curl_h2": True, "driven": True}


def read_response(sock) -> tuple:
    """(status, body) of an HTTP/1.1 response with Content-Length."""
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(65536)
        if not chunk:
            raise AssertionError(f"connection closed mid-response: {data[:200]!r}")
        data += chunk
    head, _, body = data.partition(b"\r\n\r\n")
    lines = head.split(b"\r\n")
    length = next(int(ln.split(b":", 1)[1]) for ln in lines[1:]
                  if ln.lower().startswith(b"content-length:"))
    while len(body) < length:
        chunk = sock.recv(65536)
        if not chunk:
            break
        body += chunk
    return int(lines[0].split()[1]), body


def obs_ingress_case(buf: bytes, launches: dict, smi: str) -> dict:
    """(e) --read-timeout 1: a connection stalled mid-header is closed
    within 1-3 s and counted in /health's ingress block; a body trickled in
    OBS_TRICKLE chunks (past the timeout in all, each gap under it) is
    served byte-equal to phase 4's; config 1 is still served."""
    import socket

    from imaginary_tpu_torch import kernels

    srv, stop = obs_server(["--read-timeout", "1"])
    port = srv.server_address[1]
    kernels.reset_launches()
    try:
        before = get_json(port, "/health")["ingress"]
        sl = socket.create_connection(("127.0.0.1", port), 5)
        sl.sendall(b"POST " + CONFIG1_PATH.encode() + b" HTTP/1.1\r\nHost: x\r\n")
        sl.settimeout(10.0)
        t0 = time.perf_counter()
        got = sl.recv(4096)
        closed_s = time.perf_counter() - t0
        sl.close()
        if got != b"" or not 0.9 <= closed_s <= 3.0:
            raise AssertionError(f"(e) the stalled read got {got[:100]!r} after "
                                 f"{closed_s:.2f} s")
        slow = socket.create_connection(("127.0.0.1", port), 5)
        slow.sendall(b"POST " + CONFIG1_PATH.encode() + b" HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: image/jpeg\r\nConnection: close\r\n"
                     b"Content-Length: " + str(len(buf)).encode() + b"\r\n\r\n")
        step = -(-len(buf) // OBS_TRICKLE)
        t1 = time.perf_counter()
        for i in range(0, len(buf), step):
            time.sleep(OBS_TRICKLE_GAP_S)
            slow.sendall(buf[i:i + step])
        slow.settimeout(60.0)
        status, body = read_response(slow)
        trickle_s = time.perf_counter() - t1
        slow.close()
        if status != 200 or body != PHASE4_ANSWERS["resize"]:
            raise AssertionError(f"(e) the trickled body: {status}, {len(body)} B")
        config1_answer(port, buf, "(e) after the slowloris")
        after = get_json(port, "/health")["ingress"]
    finally:
        stop()
    add_launches(launches, kernels.launch_counts())
    if after["read_timeouts"] != before["read_timeouts"] + 1:
        raise AssertionError(f"(e) read_timeouts {before} -> {after}")
    log(f"  (e) --read-timeout 1: the stalled header read closed after {closed_s:.3f} s and "
        f"counted (ingress {after}); a body trickled over {trickle_s:.2f} s served "
        f"byte-equal; config 1 still served  [{smi}]")
    return {"closed_after_s": closed_s, "trickle_s": trickle_s, "ingress": after}


def env_failpoints_case(buf: bytes, launches: dict) -> dict:
    """(f) a server from the port's command line with IMAGINARY_TPU_FAILPOINTS
    set and --enable-debug: GET /debugz/failpoints shows the spec armed and
    every known site; config 1 answers the reference's 400 for the armed
    codec.encode error (the card ran the chain before the encode, and
    device.slow[0] was hit there); after an empty PUT config 1 answers
    phase 4's bytes. Then `python -m imaginary_tpu_torch` with a bad spec
    exits non-zero before it binds."""
    from imaginary_tpu_torch import failpoints, kernels

    t0 = time.perf_counter()
    saved = os.environ.get(failpoints.ENV_VAR)
    os.environ[failpoints.ENV_VAR] = FAILPOINT_ENV_SPEC
    try:
        srv, stop = obs_server(["--enable-debug"])
    finally:  # later phases' servers and workers inherit this environment
        if saved is None:
            os.environ.pop(failpoints.ENV_VAR)
        else:
            os.environ[failpoints.ENV_VAR] = saved
    out: dict = {}
    try:
        port = srv.server_address[1]
        snap = get_json(port, "/debugz/failpoints")
        if (not snap["enabled"] or snap["spec"] != FAILPOINT_ENV_SPEC
                or snap["known_sites"] != list(failpoints.SITES)
                or len(snap["known_sites"]) != 22
                or set(snap) != {"enabled", "spec", "sites", "known_sites"}):
            raise AssertionError(f"(f) /debugz/failpoints after an env boot: {snap}")
        kernels.reset_launches()
        status, headers, body = http_get(port, CONFIG1_PATH, method="POST", body=buf,
                                         headers={"Content-Type": "image/jpeg"})
        ctype = headers.get("Content-Type", "")
        message = json.loads(body).get("message", "") if "json" in ctype else ""
        if (status, message) != (400, FAILPOINT_ENV_ANSWER):
            raise AssertionError(f"(f) config 1 with codec.encode armed: {status} {ctype} "
                                 f"{body[:200]!r}")
        fired = get_json(port, "/debugz/failpoints")["sites"]
        if fired["codec.encode"]["fired"] != 1 or fired["device.slow[0]"]["fired"] < 1:
            raise AssertionError(f"(f) the armed sites after one request: {fired}")
        disarmed = json.loads(http_get(port, "/debugz/failpoints", method="PUT", body=b"")[2])
        if disarmed["enabled"] or disarmed["spec"]:
            raise AssertionError(f"(f) an empty PUT left {disarmed}")
        out["disarmed_ms"] = config1_answer(port, buf, "(f) disarmed")
        ran = kernels.launch_counts()
        add_launches(launches, ran)
        out.update({"status": status, "message": message, "sites": fired})
    finally:
        stop()
        failpoints.deactivate()
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "imaginary_tpu_torch", "--addr", "127.0.0.1", "--port",
         str(free_port()), "--device", DEVICE, "--log-level", "error"],
        cwd=ROOT, env=dict(os.environ, **{failpoints.ENV_VAR: FAILPOINT_BAD_SPEC}),
        capture_output=True, text=True, timeout=FAILPOINT_BOOT_S)
    if proc.returncode == 0 or "unknown failpoint site 'nope'" not in proc.stderr:
        raise AssertionError(f"(f) a boot with {FAILPOINT_BAD_SPEC!r}: exit {proc.returncode}, "
                             f"{proc.stderr[-1000:]}")
    out.update({"bad_boot_exit": proc.returncode, "bad_boot_s": time.perf_counter() - t1,
                "seconds": time.perf_counter() - t0})
    log(f"  (f) IMAGINARY_TPU_FAILPOINTS={FAILPOINT_ENV_SPEC!r}: /debugz/failpoints shows it "
        f"and {len(failpoints.SITES)} known sites; config 1 answered {status} {message!r} "
        f"(codec.encode fired 1, device.slow[0] {fired['device.slow[0]']['fired']}), then "
        f"phase 4's bytes after an empty PUT; {FAILPOINT_BAD_SPEC!r} failed the boot with "
        f"exit {proc.returncode} in {out['bad_boot_s']:.1f} s; (f): {out['seconds']:.1f} s")
    return out


def obs_phase(smi: str) -> dict:
    """Phase 19 (see the module docstring): the port's server with every
    observability plane armed, on the card."""
    from imaginary_tpu_torch import kernels

    t0 = time.perf_counter()
    bodies = {}
    for _, src, _ in CONFIG2_REQUESTS:
        with open(src, "rb") as f:
            bodies[src] = f.read()
    buf = bodies[LARGE_JPG]
    kernels.reset_launches()
    launches = dict(kernels.launch_counts())
    sink = LineSink()
    armed, stop_armed = obs_server(OBS_PLANES, log_stream=sink)
    off, stop_off = obs_server([])
    try:
        out = {"surfaces": obs_surfaces_case(armed, sink, bodies, launches, smi),
               "profile": obs_profile_case(armed, buf, launches, smi),
               "latency": obs_latency_case(armed, off, buf, launches, smi)}
    finally:
        stop_armed()
        stop_off()
    out["h2"] = obs_h2_case(buf, launches, smi)
    out["ingress"] = obs_ingress_case(buf, launches, smi)
    out["env_failpoints"] = env_failpoints_case(buf, launches)
    for name in CONFIG2_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched in phase 19")
    out["plane_vs_profiler_ms"] = {
        "cost_device_ms_per_request": out["surfaces"]["config1_cost_device_ms"],
        "card_ms_per_request": out["profile"]["card_ms_per_request"]}
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    log(f"  config 1 a request: the plane books {out['surfaces']['config1_cost_device_ms']:.4f} "
        f"ms (drain wall), the profiler saw {out['profile']['card_ms_per_request']:.4f} ms of "
        f"card time  [{smi}]")
    log(f"  launches: {launches}; phase 19: {out['seconds']:.1f} s")
    return out


# -- phase 20: the single-host fleet ------------------------------------------

FLEET_SERIAL = 10  # (a): config 1, one request at a time
FLEET_CLIENTS, FLEET_PER_CLIENT = 16, 4  # (a): one window a server
FLEET_BOOT_S = 180  # every worker of a fleet answering /health
FLEET_ROLL_S = 180  # (b): both replacements answering at their new epochs
FLEET_ROLL_GRACE = "1"  # (b): --fleet-roll-grace
FLEET_ROLL_TAIL_S = 3.0  # (b): serial requests after the roll's last epoch
FLEET_RESPAWN_S = 120  # (c): the killed index answering at a new epoch
FLEET_FORWARD_WIDTHS = range(301, 317)  # (d): sixteen digests for the forward hop
FLEET_SHM_REQUESTS = 12  # (d): config 1 on the shm tier


def compute_apps():
    """[(pid, used MiB)] of the card's compute processes, one a CUDA
    context, from nvidia-smi; None where nvidia-smi is absent."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return None
    apps = []
    for line in out.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            try:
                apps.append((int(parts[0]), float(parts[1])))
            except ValueError:
                apps.append((int(parts[0]), None))
    return apps


def device_used_mib():
    """The card's used memory in MiB, every process's (cudaMemGetInfo from
    this process); None on the CPU."""
    if DEVICE == "cpu":
        return None
    import torch

    free, total = torch.cuda.mem_get_info(0)
    return (total - free) / 2**20


def maps_card(pid: int) -> bool:
    """Whether process `pid` maps the card's device files, as a process
    with a CUDA context does (importing torch maps libcuda, and counting
    the cards opens the device files, but neither maps them)."""
    with open(f"/proc/{pid}/maps") as f:
        return any("/dev/nvidia" in line for line in f)


def opens_uvm(pid: int) -> bool:
    """Whether process `pid` holds /dev/nvidia-uvm open, as a process
    that initialised the CUDA driver does."""
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            if os.readlink(f"/proc/{pid}/fd/{fd}") == "/dev/nvidia-uvm":
                return True
        except OSError:
            continue
    return False


def fleet_device() -> str:
    return "cuda:0" if DEVICE == "cuda" else DEVICE


class FleetProcess:
    """`python -m imaginary_tpu_torch.cli --workers N` on 127.0.0.1: the
    supervisor and its workers, their output in chip_smoke_out/<name>.out
    and .err. `latest` keeps each worker incarnation's (index, epoch) last
    /health read, whose kernelLaunches are that process's launches."""

    def __init__(self, name: str, workers: int, args: list, port=None, env=None):
        self.name = name
        self.workers = workers
        self.port = port or free_port()
        self.latest: dict = {}
        os.makedirs(OUT_DIR, exist_ok=True)
        self.out_path = os.path.join(OUT_DIR, f"{name}.out")
        self.err_path = os.path.join(OUT_DIR, f"{name}.err")
        self._out = open(self.out_path, "w")
        self._err = open(self.err_path, "w")
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "imaginary_tpu_torch.cli", "--workers", str(workers),
             "--addr", "127.0.0.1", "--port", str(self.port), "--device", fleet_device(),
             "--log-level", "error", "--mount", TESTDATA] + args,
            cwd=ROOT, stdout=self._out, stderr=self._err, env=env)
        try:
            self.boot = self.wait_workers(FLEET_BOOT_S)
        except BaseException:
            self.stop()
            raise
        self.boot_s = time.perf_counter() - t0

    def health(self) -> dict:
        h = json.loads(http_get(self.port, "/health")[2])
        self.latest[(h["worker"], h["epoch"])] = h
        return h

    def wait_workers(self, seconds: float, newer_than=None) -> dict:
        """{index: /health} once every worker index has answered (each at
        an epoch above newer_than[index] where given)."""
        seen: dict = {}
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise AssertionError(f"{self.name}: the supervisor exited "
                                     f"{self.proc.returncode}: {self.stderr()[-2000:]}")
            try:
                h = self.health()
            except (OSError, ValueError):
                time.sleep(0.1)
                continue
            w = h["worker"]
            if newer_than is None or h["epoch"] > newer_than.get(w, 0):
                seen[w] = h
            if len(seen) == self.workers:
                return seen
        raise AssertionError(f"{self.name}: workers {sorted(seen)} of {self.workers} "
                             f"answered in {seconds} s")

    def stderr(self) -> str:
        with open(self.err_path) as f:
            return f.read()

    def launches(self) -> dict:
        import collections

        total: collections.Counter = collections.Counter()
        for h in self.latest.values():
            total.update(h["kernelLaunches"])
        return dict(total)

    def stop(self) -> None:
        import signal

        if self.proc.poll() is None:
            try:  # each worker's last launches, before the drain
                self.wait_workers(10)
            except (AssertionError, OSError):
                pass
        pids = {h["pid"] for h in self.latest.values()}
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=40)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        for pid in pids:  # no worker outlives the phase
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        self._out.close()
        self._err.close()


def fleet_window(port: int, buf: bytes, want: bytes) -> float:
    """req/s of FLEET_CLIENTS clients x FLEET_PER_CLIENT config 1 requests,
    each answer byte-equal to `want`."""
    errors: list = []

    def client():
        try:
            for _ in range(FLEET_PER_CLIENT):
                status, ctype, body = http(port, CONFIG1_PATH, buf)
                if (status, ctype, body) != (200, "image/jpeg", want):
                    raise AssertionError(f"config 1 answered {status} {ctype}, "
                                         f"byte-equal {body == want}")
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=client) for _ in range(FLEET_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return FLEET_CLIENTS * FLEET_PER_CLIENT / wall


def fleet_serial(port: int, buf: bytes, want: bytes, n: int) -> list:
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        status, ctype, body = http(port, CONFIG1_PATH, buf)
        lat.append((time.perf_counter() - t0) * 1e3)
        if (status, ctype, body) != (200, "image/jpeg", want):
            raise AssertionError(f"config 1 answered {status} {ctype}, "
                                 f"byte-equal {body == want}")
    return lat


def host_placements(h: dict) -> int:
    ex = h["executor"]
    return (ex["spilled"] + ex["breaker_host_served"] + ex["hedges"]["launched"]
            + ex.get("pressure_host_forced", 0))


def fleet_two_case(fleet: FleetProcess, single: dict, buf: bytes, want: bytes,
                   smi: str, base_mib, base_apps) -> dict:
    """(a): the two-worker fleet against one process on config 1."""
    serial = fleet_serial(fleet.port, buf, want, FLEET_SERIAL)
    rps = fleet_window(fleet.port, buf, want)
    seen = fleet.wait_workers(30)
    workers = {}
    for w, h in sorted(seen.items()):
        launched = {k: h["kernelLaunches"][k] for k in CONFIG1_KERNELS}
        if h["device"] != fleet_device():
            raise AssertionError(f"worker {w} serves on {h['device']}")
        if DEVICE != "cpu" and min(launched.values()) <= 0:
            raise AssertionError(f"worker {w} launched {launched}")
        if host_placements(h):
            raise AssertionError(f"worker {w} placed work on the host: {h['executor']}")
        workers[w] = {"pid": h["pid"], "epoch": h["epoch"], "device": h["device"],
                      "launches": launched, "items": h["executor"]["items"],
                      "allocated_device_mb": h.get("allocatedDeviceMb")}
    apps = compute_apps()
    used = device_used_mib()
    memory = {"compute_apps": apps, "base_apps": base_apps, "device_used_mib": used,
              "base_mib": base_mib}
    if DEVICE != "cpu":
        if apps is None:
            raise AssertionError("nvidia-smi's compute apps are unreadable")
        # nvidia-smi names processes by the pids of its own namespace;
        # where they are not this one's, the count of contexts over this
        # process's own, and each process's mappings of the card, tell who
        # holds a context, and the card's used memory what the two
        # workers hold between them
        pids = {pid for pid, _ in apps}
        memory["pid_namespace_matches"] = os.getpid() in pids
        for w, rec in workers.items():
            if memory["pid_namespace_matches"]:
                rec["used_mib"] = dict(apps).get(rec["pid"])
                if not rec["used_mib"]:
                    raise AssertionError(f"worker {w} (pid {rec['pid']}) is not a compute "
                                         f"app with device memory: {apps}")
            if not maps_card(rec["pid"]):
                raise AssertionError(f"worker {w} (pid {rec['pid']}) maps no card")
        sup = fleet.proc.pid
        if (memory["pid_namespace_matches"] and sup in pids) or maps_card(sup) \
                or opens_uvm(sup):
            raise AssertionError(f"the supervisor (pid {sup}) initialised CUDA: {apps}")
        if len(apps) != len(base_apps) + 2:
            raise AssertionError(f"{len(apps)} contexts on the card with the fleet up, "
                                 f"{len(base_apps)} before it: {apps}")
        memory["per_worker_mib"] = (used - base_mib) / 2
        memory["workers_0_contexts"] = os.cpu_count() or 1
        memory["workers_0_mib"] = (os.cpu_count() or 1) * memory["per_worker_mib"]
    out = {"serial_ms": serial, "serial_p50_ms": statistics.median(serial), "rps": rps,
           "single_rps": single["rps"], "workers": workers, "memory": memory,
           "boot_s": fleet.boot_s}
    log(f"  (a) 2 workers: config 1 x {FLEET_SERIAL} p50 {out['serial_p50_ms']:.2f} ms, "
        f"{FLEET_CLIENTS} clients {rps:.1f} req/s; one process {single['rps']:.1f} req/s "
        f"(one window each, no claim)  [{smi}]")
    for w, rec in workers.items():
        log(f"      worker {w}: pid {rec['pid']} epoch {rec['epoch']} on {rec['device']}, "
            f"launches {rec['launches']}, items {rec['items']}, "
            f"device memory {rec.get('used_mib')} MiB")
    if "per_worker_mib" in memory:
        log(f"      the supervisor holds no context; the card's used memory rose "
            f"{used - base_mib:.0f} MiB for the two loaded workers, "
            f"{memory['per_worker_mib']:.0f} MiB a worker; --workers 0 here would be "
            f"{memory['workers_0_contexts']} contexts, ~{memory['workers_0_mib']:.0f} MiB; "
            f"nvidia-smi's compute apps {apps} (before the fleet: {base_apps})")
    return out


def fleet_roll_case(fleet: FleetProcess, buf: bytes, want: bytes) -> dict:
    """(b): SIGHUP rolls both workers while config 1 runs one request at a
    time; every answer is 200 and byte-equal, and both epochs advance."""
    import signal

    before = {w: h["epoch"] for w, h in fleet.wait_workers(30).items()}
    stop = threading.Event()
    answers: list = []

    def serial():
        while not stop.is_set():
            try:
                status, _, body = http_get(fleet.port, CONFIG1_PATH,
                                           {"Content-Type": "image/jpeg"}, "POST", buf)
                answers.append((status, body == want))
            except OSError as e:
                answers.append((repr(e), False))

    th = threading.Thread(target=serial)
    th.start()
    t0 = time.perf_counter()
    try:
        time.sleep(0.5)
        fleet.proc.send_signal(signal.SIGHUP)
        after = fleet.wait_workers(FLEET_ROLL_S, newer_than=before)
        roll_s = time.perf_counter() - t0
        time.sleep(FLEET_ROLL_TAIL_S)
    finally:
        stop.set()
        th.join(timeout=130)
    bad = [a for a in answers if a != (200, True)]
    epochs = {w: h["epoch"] for w, h in after.items()}
    out = {"before": before, "after": epochs, "answers": len(answers), "bad": bad[:10],
           "roll_s": roll_s}
    log(f"  (b) SIGHUP: epochs {before} -> {epochs} in {roll_s:.1f} s; {len(answers)} serial "
        f"answers, {len(bad)} not 200 and byte-equal")
    if bad:
        raise AssertionError(f"the roll answered {bad[:10]}")
    if not all(epochs[w] > before[w] for w in before):
        raise AssertionError(f"the epochs did not advance: {before} -> {epochs}")
    return out


def fleet_respawn_case(fleet: FleetProcess, buf: bytes, want: bytes) -> dict:
    """(c): SIGKILL one worker; its index answers again at a new epoch,
    launches its own kernels and answers byte-equal."""
    import signal

    victim = fleet.health()
    idx, pid, epoch = victim["worker"], victim["pid"], victim["epoch"]
    t0 = time.perf_counter()
    os.kill(pid, signal.SIGKILL)
    back = fleet.wait_workers(FLEET_RESPAWN_S, newer_than={idx: epoch, 1 - idx: -1})[idx]
    respawn_s = time.perf_counter() - t0
    deadline = time.monotonic() + 60
    served = 0
    while True:
        fleet_serial(fleet.port, buf, want, 2)
        served += 2
        h = fleet.health()
        if h["worker"] == idx and h["epoch"] == back["epoch"] and (
                DEVICE == "cpu" or h["kernelLaunches"]["resample"] > 0):
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"worker {idx} at epoch {back['epoch']} never served config 1")
    out = {"index": idx, "old_pid": pid, "old_epoch": epoch, "pid": back["pid"],
           "epoch": back["epoch"], "respawn_s": respawn_s, "requests": served}
    log(f"  (c) SIGKILL worker {idx} (pid {pid}, epoch {epoch}): back as pid {back['pid']} at "
        f"epoch {back['epoch']} in {respawn_s:.1f} s, {served} answers byte-equal")
    return out


def fleet_planes_case(fleet: FleetProcess, admin_port: int, buf: bytes, want: bytes) -> dict:
    """(d): the shm tier, the forward hop, the claims and the admin plane."""
    from imaginary_tpu_torch import codecs

    def workers_now():
        return fleet.wait_workers(30)

    # each worker's first launch loads its kernels and its allocator's
    # first blocks, longer than the hop's budget: a cold owner makes its
    # siblings fall back to a local run. Warm both on other digests first
    deadline = time.monotonic() + 60
    warm = 0
    while True:
        start = workers_now()
        if DEVICE == "cpu" or min(h["kernelLaunches"]["resample"] for h in start.values()):
            break
        if time.monotonic() > deadline:
            raise AssertionError("a worker of the planes fleet never launched")
        http(fleet.port, f"/resize?width={280 + warm % 16}&height=200", buf)
        warm += 1
    base = {w: dict(h["kernelLaunches"]) for w, h in start.items()}
    fleet_serial(fleet.port, buf, want, FLEET_SHM_REQUESTS)
    mid = workers_now()
    computed = {w: {k: mid[w]["kernelLaunches"][k] - base[w][k] for k in CONFIG1_KERNELS}
                for w in mid}
    hits = {w: mid[w]["fleet"]["hits"] for w in mid}
    total = {k: sum(c[k] for c in computed.values()) for k in CONFIG1_KERNELS}
    if DEVICE != "cpu" and total != {k: 1 for k in CONFIG1_KERNELS}:
        raise AssertionError(f"config 1 x {FLEET_SHM_REQUESTS} launched {computed}, not once")
    if min(hits.values()) < 1:
        raise AssertionError(f"not every worker served from the shm tier: {hits}")
    for width in FLEET_FORWARD_WIDTHS:
        status, ctype, body = http(fleet.port, f"/resize?width={width}&height=200", buf)
        if status != 200 or codecs.decode(body).array.shape[:2] != (200, width):
            raise AssertionError(f"/resize?width={width}: {status} {ctype}")
    end = workers_now()
    coh = {w: h["fleet"]["coherence"] for w, h in end.items()}
    claims = {w: h["fleet"]["claims_won"] for w, h in end.items()}
    forwards = sum(c["forwards"] for c in coh.values())
    served = sum(c["serve_forwarded"] for c in coh.values())
    if forwards < 1 or served < 1 or sum(claims.values()) < 1:
        raise AssertionError(f"the hop or the claims did not move: {coh}, claims {claims}")
    owners = {c["device_owner"] for c in coh.values()}
    fleetz = json.loads(http_get(admin_port, "/fleetz")[2])
    listed = {w for w, rec in fleetz["workers"].items()
              if rec.get("health") is not None and not rec["stale"]}
    metrics = http_get(admin_port, "/metrics?per_worker=1")[2].decode()
    labelled = {w for w in ("0", "1") if f'worker="{w}"' in metrics}
    if listed != {"0", "1"} or labelled != {"0", "1"}:
        raise AssertionError(f"/fleetz lists {listed}, the merged /metrics {labelled}")
    merged = http_get(admin_port, "/metrics")[2].decode()
    out = {"warm_requests": warm, "computed": computed, "shm_hits": hits, "coherence": coh,
           "claims_won": claims,
           "device_owner": sorted(owners), "fleetz_workers": sorted(listed),
           "metrics_workers": sorted(labelled),
           "merged_families": sum(1 for ln in merged.splitlines() if ln.startswith("# TYPE"))}
    log(f"  (d) after {warm} warming requests, config 1 x {FLEET_SHM_REQUESTS}: launches by "
        f"worker {computed}, shm hits "
        f"{hits}; {len(FLEET_FORWARD_WIDTHS)} digests: forwards {forwards}, served for a "
        f"sibling {served}, claims won {claims}; device owner {sorted(owners)}; /fleetz and "
        f"the merged /metrics list workers {sorted(listed)}")
    return out


def booting(make):
    """Run make() on a thread; the returned join() gives its result, or
    raises its error."""
    box: dict = {}

    def run():
        try:
            box["value"] = make()
        except BaseException as e:  # re-raised by join, in the caller's thread
            box["error"] = e

    th = threading.Thread(target=run)
    th.start()

    def join():
        th.join()
        if "error" in box:
            raise box["error"]
        return box["value"]

    return join


def fleet_phase(smi: str) -> dict:
    """Phase 20 (see the module docstring): the --workers supervisor and
    the single-host fleet on the card. Each fleet boots while the work
    before it runs: the two-worker fleet beside the one process, the
    planes' fleet during (c)."""
    import collections

    t0 = time.perf_counter()
    with open(LARGE_JPG, "rb") as f:
        buf = f.read()
    want = PHASE4_ANSWERS.get("resize")
    if want is None:
        raise AssertionError("phase 4's config 1 answer is missing")
    launches: collections.Counter = collections.Counter()
    out = {}
    if DEVICE != "cpu":
        import torch

        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # this process's share stays put from here
    base_mib, base_apps = device_used_mib(), compute_apps()
    admin = free_port()
    # boots in flight; each is popped before it is joined (a boot that
    # fails stops its own processes)
    pending = {"two": booting(lambda: FleetProcess("fleet_two", 2, [
        "--fleet-roll-grace", FLEET_ROLL_GRACE]))}
    fleet = planes = None
    try:
        single = ServerProcess("fleet_single", [])
        try:
            fleet_serial(single.port, buf, want, 2)
            rec = {"rps": fleet_window(single.port, buf, want), "pid": single.proc.pid}
            launches.update(single.health()["kernelLaunches"])
        finally:
            single.stop()
        fleet = pending.pop("two")()
        out["two"] = fleet_two_case(fleet, rec, buf, want, smi, base_mib, base_apps)
        out["roll"] = fleet_roll_case(fleet, buf, want)
        pending["planes"] = booting(lambda: FleetProcess("fleet_planes", 2, [
            "--fleet-cache-mb", "64", "--fleet-coherence", "--fleet-qos",
            "--fleet-admin-port", str(admin)]))
        out["respawn"] = fleet_respawn_case(fleet, buf, want)
        fleet.stop()
        launches.update(fleet.launches())
        fleet = None
        planes = pending.pop("planes")()
        out["planes"] = fleet_planes_case(planes, admin, buf, want)
    finally:
        for join in pending.values():  # a boot still running when a step failed
            try:
                join().stop()
            except Exception as e:  # the step's own error is the one raised
                log(f"  a fleet's boot failed too: {e}")
        for proc in (fleet, planes):
            if proc is not None:
                proc.stop()
                launches.update(proc.launches())
    out["launches"] = {k: launches.get(k, 0) for k in KERNEL_ROWS}
    if DEVICE != "cpu":
        for name in CONFIG1_KERNELS:
            if out["launches"][name] <= 0:
                raise AssertionError(f"kernel {name} was not launched in phase 20")
    out["seconds"] = time.perf_counter() - t0
    log(f"  launches (every worker's /health): {out['launches']}; phase 20: "
        f"{out['seconds']:.1f} s")
    return out


# -- phase 21: two hosts of the port on one card ------------------------------

MH_PROBE = "0.3"  # --peer-probe-interval
MH_CONVERGE_S = 60  # gossip crossing both ways (and a restarted host's new epoch)
MH_HUNT = range(321, 353)  # (a): 32 config 1 variants, about half of them owned by B
MH_BURST = range(353, 385)  # (b): the B-owned ones sent the instant B's workers die
MH_AFTER = range(385, 401)  # (b): after B is gone
MH_RESUME = range(401, 433)  # (c)
MH_SPILL = range(433, 441)  # (d): four spilled, four shed
MH_BURST_CLIENTS = 8
MH_QOS = json.dumps({"default": {"class": "standard"},
                     "tenants": [{"name": "bulk", "class": "batch", "api_keys": ["bulk-key"]}]})
MH_ROUTE = "X-Imaginary-Route"
MH_EPOCH = "X-Imaginary-Host-Epoch"
MH_COUNTERS = ("forwards", "forward_fails", "fenced_answers", "spills", "spill_fails",
               "served_for_peer", "local_fallbacks")


def mh_path(width: int) -> str:
    return f"/resize?width={width}&height=200"


def mh_owner(buf: bytes, width: int) -> str:
    """The owner host of config 1 at `width`: host rendezvous over the
    request's shared key, as the hosts' routers elect it."""
    from imaginary_tpu_torch import cache
    from imaginary_tpu_torch.fleet import multihost
    from imaginary_tpu_torch.params import build_params_from_query

    opts = build_params_from_query({"width": str(width), "height": "200"})
    skey = cache.shared_key(cache.request_key(cache.source_digest(buf), "resize", opts))
    return multihost.rendezvous_host(["host-a", "host-b"], skey)


def mh_host(name: str, hid: str, port: int, admin: int, peer_admin: int) -> FleetProcess:
    """One host: a supervisor of two workers on card 0 with its admin plane,
    pointed at the other host's admin plane, routing on, its own shm file
    (no inherited fleet path or host identity)."""
    env = dict(os.environ)
    for name_ in ("IMAGINARY_TPU_FLEET_PATH", "IMAGINARY_TPU_HOST_ID",
                  "IMAGINARY_TPU_HOST_EPOCH"):
        env.pop(name_, None)
    return FleetProcess(name, 2, [
        "--host-id", hid, "--peers", f"http://127.0.0.1:{peer_admin}", "--router",
        "--peer-probe-interval", MH_PROBE, "--fleet-cache-mb", "64",
        "--fleet-admin-port", str(admin), "--enable-debug",
        "--pressure-rss-mb", "1000000", "--qos-config", MH_QOS], port=port, env=env)


def mh_stats(host: FleetProcess) -> tuple:
    """({index: /health}, the host's summed cross-host counters)."""
    seen = host.wait_workers(30)
    tot = {k: sum(h["multihost"][k] for h in seen.values()) for k in MH_COUNTERS}
    return seen, tot


def mh_identity(host: FleetProcess) -> str:
    h = host.health()["host"]
    return f"{h['id']}:{h['epoch']}"


def mh_cluster(admin: int) -> dict:
    return json.loads(http_get(admin, "/fleetz?scope=cluster")[2])


def mh_wait_peer(admin: int, hid: str, newer_than: int = 0) -> dict:
    """The admin plane's cluster view once `hid` reads alive at an epoch
    above `newer_than`."""
    deadline = time.monotonic() + MH_CONVERGE_S
    while True:
        try:
            view = mh_cluster(admin)
            rec = view.get("hosts", {}).get(hid, {})
            if rec.get("alive") and rec.get("epoch", 0) > newer_than:
                return view
        except (OSError, ValueError):
            pass
        if time.monotonic() > deadline:
            raise AssertionError(f"the admin plane on {admin} never saw {hid} alive above "
                                 f"epoch {newer_than}")
        time.sleep(0.3)


def mh_warm(host: FleetProcess, buf: bytes) -> int:
    """Requests pinned to the host (X-Imaginary-Route: local) until each of
    its workers has launched: a cold worker's first launch outlasts the
    250 ms hop, and its forwarder would then run locally."""
    deadline = time.monotonic() + 60
    n = 0
    while True:
        seen = host.wait_workers(30)
        if DEVICE == "cpu" or min(h["kernelLaunches"]["resample"] for h in seen.values()):
            return n
        if time.monotonic() > deadline:
            raise AssertionError(f"{host.name}: a worker never launched")
        http_get(host.port, mh_path(280 + n % 16), {"Content-Type": "image/jpeg",
                                                    MH_ROUTE: "local"}, "POST", buf)
        n += 1


def mh_post(port: int, path: str, buf: bytes) -> tuple:
    """(status, headers, body, ms) of one config 1 POST."""
    t0 = time.perf_counter()
    status, headers, body = http_get(port, path, {"Content-Type": "image/jpeg",
                                                  "Connection": "close"}, "POST", buf)
    return status, headers, body, (time.perf_counter() - t0) * 1e3


def mh_check(host: FleetProcess, seen: dict) -> dict:
    """Every worker serves on cuda:0 and placed nothing on the host; its
    config 1 launches."""
    out = {}
    for w, h in sorted(seen.items()):
        if h["device"] != fleet_device():
            raise AssertionError(f"{host.name} worker {w} serves on {h['device']}")
        if host_placements(h):
            raise AssertionError(f"{host.name} worker {w} placed work on the host: "
                                 f"{h['executor']}")
        out[w] = {k: h["kernelLaunches"][k] for k in CONFIG1_KERNELS}
    return out


def mh_summed(launches: dict) -> dict:
    return {k: sum(rec[k] for rec in launches.values()) for k in CONFIG1_KERNELS}


def mh_forward_case(a, b, buf: bytes, want: dict, smi: str, base_mib, base_apps) -> dict:
    """(a): config 1 variants to A until the owner host B served some over
    the hop; every answer byte-equal to one process's, B's stamp on its own
    answers, B's workers launching, nothing on the host."""
    ids = {"a": mh_identity(a), "b": mh_identity(b)}
    _, a0 = mh_stats(a)
    seen_b0, b0 = mh_stats(b)
    b_launch0 = mh_summed(mh_check(b, seen_b0))
    lat: dict = {"host-a": [], "host-b": []}
    owners = {}
    for w in MH_HUNT:
        status, headers, body, ms = mh_post(a.port, mh_path(w), buf)
        if status != 200 or body != want[w]:
            raise AssertionError(f"A's /resize?width={w}: {status}, byte-equal {body == want[w]}")
        if headers.get(MH_EPOCH) != ids["a"]:
            raise AssertionError(f"A's answer is stamped {headers.get(MH_EPOCH)}, not {ids['a']}")
        owners[w] = mh_owner(buf, w)
        lat[owners[w]].append(ms)
    seen_a, a1 = mh_stats(a)
    seen_b, b1 = mh_stats(b)
    b_launch1 = mh_summed(mh_check(b, seen_b))
    mh_check(a, seen_a)
    forwards = a1["forwards"] - a0["forwards"]
    served = b1["served_for_peer"] - b0["served_for_peer"]
    fenced = a1["fenced_answers"] - a0["fenced_answers"]
    rise = {k: b_launch1[k] - b_launch0[k] for k in CONFIG1_KERNELS}
    b_owned = [w for w in MH_HUNT if owners[w] == "host-b"]
    if forwards < 1 or served < forwards or fenced:
        raise AssertionError(f"the hop: {forwards} forwards, {served} served for a peer, "
                             f"{fenced} fenced answers over {len(b_owned)} B-owned digests")
    if DEVICE != "cpu" and min(rise.values()) < forwards:
        raise AssertionError(f"B's workers launched {rise} for {forwards} forwards")
    # the owner's answer to the same request: byte-equal, stamped with B's
    # identity (the stamp the forwarder's fence check read)
    for w in b_owned:
        status, headers, body, _ = mh_post(b.port, mh_path(w), buf)
        if status != 200 or body != want[w] or headers.get(MH_EPOCH) != ids["b"]:
            raise AssertionError(f"B's /resize?width={w}: {status} stamped "
                                 f"{headers.get(MH_EPOCH)}, byte-equal {body == want[w]}")
    apps = compute_apps()
    used = device_used_mib()
    memory = {"compute_apps": apps, "base_apps": base_apps, "device_used_mib": used,
              "base_mib": base_mib}
    if used is not None and base_mib is not None:
        memory["per_context_mib"] = (used - base_mib) / 4
    p50 = {k: statistics.median(v) if v else None for k, v in lat.items()}
    out = {"identities": ids, "forwards": forwards, "served_for_peer": served,
           "fenced_answers": fenced, "b_owned": len(b_owned), "hunted": len(MH_HUNT),
           "b_launch_rise": rise, "lat_ms": lat, "p50_local_ms": p50["host-a"],
           "p50_forwarded_ms": p50["host-b"], "memory": memory,
           "a_counters": a1, "b_counters": b1}
    log(f"  (a) {len(MH_HUNT)} config 1 variants to A ({ids['a']}): {forwards} forwarded to B "
        f"({ids['b']}), {served} served for a peer, {fenced} fenced; all byte-equal to one "
        f"process and stamped {ids['a']}; B's answers to the same {len(b_owned)} B-owned "
        f"requests stamped {ids['b']}; B's K1-K4 rose {rise}; no host placement")
    log(f"      p50 forwarded {p50['host-b']:.2f} ms ({len(lat['host-b'])}) against local "
        f"{p50['host-a']:.2f} ms ({len(lat['host-a'])}), one request at a time, each digest "
        f"computed once (no claim)  [{smi}]")
    log(f"      device memory: nvidia-smi's compute apps {apps} (before the hosts: "
        f"{base_apps}); the card's used memory rose "
        f"{(used - base_mib) if used is not None else 0:.0f} MiB for the four workers, "
        f"{memory.get('per_context_mib', 0):.0f} MiB a context")
    return out


def mh_children(pid: int) -> list:
    """The child pids of `pid` (a supervisor's workers, respawns included)."""
    try:
        with open(f"/proc/{pid}/task/{pid}/children") as f:
            return [int(c) for c in f.read().split()]
    except OSError:
        return []


def mh_failopen_case(a, b, buf: bytes, want: dict) -> dict:
    """(b): SIGKILL B's workers, send B-owned digests to A at once (B's admin
    plane still answers gossip: the dial is refused), then SIGKILL B's
    supervisor; every answer from A is 200 and byte-equal."""
    import signal

    _, a0 = mh_stats(a)
    seen_b = b.wait_workers(30)
    sup = b.proc.pid
    burst = [w for w in MH_BURST if mh_owner(buf, w) == "host-b"]
    answers: list = []
    lock = threading.Lock()

    def client(widths):
        for w in widths:
            try:
                status, _, body, _ = mh_post(a.port, mh_path(w), buf)
                got = (w, status, body == want[w])
            except OSError as e:
                got = (w, repr(e), False)
            with lock:
                answers.append(got)

    for h in seen_b.values():
        os.kill(h["pid"], signal.SIGKILL)
    t_kill = time.perf_counter()
    threads = [threading.Thread(target=client, args=(burst[i::MH_BURST_CLIENTS],))
               for i in range(MH_BURST_CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    burst_s = time.perf_counter() - t_kill
    for pid in [sup] + mh_children(sup):
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    b.proc.wait(timeout=30)
    b.stop()
    try:  # the killed supervisor's shm file
        os.unlink(f"/dev/shm/imaginary-fleet-{sup}.shm")
    except OSError:
        pass
    for w in MH_AFTER:
        try:
            status, _, body, _ = mh_post(a.port, mh_path(w), buf)
            answers.append((w, status, body == want[w]))
        except OSError as e:
            answers.append((w, repr(e), False))
    seen_a, a1 = mh_stats(a)
    mh_check(a, seen_a)
    bad = [x for x in answers if x[1:] != (200, True)]
    fails = {k: a1[k] - a0[k] for k in ("forward_fails", "local_fallbacks", "forwards")}
    if bad:
        raise AssertionError(f"A answered {bad[:5]} with B gone")
    if fails["forward_fails"] + fails["local_fallbacks"] < 1:
        raise AssertionError(f"no hop failed open: {fails}")
    out = {"answers": len(answers), "burst": len(burst), "burst_s": burst_s, **fails,
           "killed": {"supervisor": sup, "workers": [h["pid"] for h in seen_b.values()]}}
    log(f"  (b) B's workers and supervisor SIGKILLed: {len(answers)} answers from A "
        f"({len(burst)} B-owned sent at once in {burst_s:.2f} s, {len(MH_AFTER)} after), all "
        f"200 and byte-equal; forward_fails {fails['forward_fails']}, local_fallbacks "
        f"{fails['local_fallbacks']}")
    return out


def mh_restart_case(a, admin_a: int, make_b, old_epoch: int, buf: bytes, want: dict):
    """(c): B again, a new incarnation: gossip shows its greater epoch and
    the forwards resume. Returns (report, the new host)."""
    t0 = time.perf_counter()
    b = make_b()
    try:
        view = mh_wait_peer(admin_a, "host-b", newer_than=old_epoch)
        rec = view["hosts"]["host-b"]
        warm = mh_warm(b, buf)
        ident = mh_identity(b)
        time.sleep(1.0)  # A's workers' own gossip, at 0.3 s a poll
        _, a0 = mh_stats(a)
        resumed = []
        for w in MH_RESUME:
            status, _, body, _ = mh_post(a.port, mh_path(w), buf)
            if status != 200 or body != want[w]:
                raise AssertionError(f"A's /resize?width={w} after B's restart: {status}, "
                                     f"byte-equal {body == want[w]}")
            if mh_owner(buf, w) == "host-b":
                resumed.append(w)
        seen_a, a1 = mh_stats(a)
        mh_check(a, seen_a)
        mh_check(b, b.wait_workers(30))
        forwards = a1["forwards"] - a0["forwards"]
        if forwards < 1 or a1["fenced_answers"] != a0["fenced_answers"]:
            raise AssertionError(f"after B's restart: {forwards} forwards, fenced "
                                 f"{a1['fenced_answers'] - a0['fenced_answers']}")
        w = resumed[0]
        status, headers, body, _ = mh_post(b.port, mh_path(w), buf)
        if headers.get(MH_EPOCH) != ident or body != want[w]:
            raise AssertionError(f"B's new answer is stamped {headers.get(MH_EPOCH)}")
    except BaseException:
        b.stop()
        raise
    out = {"old_epoch": old_epoch, "epoch": rec["epoch"], "epoch_bumps": rec.get("epoch_bumps"),
           "identity": ident, "warm_requests": warm, "forwards": forwards,
           "b_owned": len(resumed), "restart_s": time.perf_counter() - t0}
    log(f"  (c) B restarted: gossip reads epoch {rec['epoch']} (was {old_epoch}, bumps "
        f"{rec.get('epoch_bumps')}) in {out['restart_s']:.1f} s; {forwards} forwards over "
        f"{len(resumed)} B-owned digests, all byte-equal")
    return out, b


def mh_arm(host: FleetProcess, spec: str, state: int) -> dict:
    """Arm `spec` on every worker of `host` (PUT /debugz/failpoints, a
    fresh connection each, until each worker's /health shows the pressure
    state `state`)."""
    deadline = time.monotonic() + 30
    while True:
        for _ in range(8):
            http_get(host.port, "/debugz/failpoints", {"Connection": "close"}, "PUT",
                     spec.encode())
        time.sleep(0.35)  # past the governor's 0.25 s sample interval
        seen = host.wait_workers(30)
        states = {w: h["pressure"]["state"] for w, h in seen.items()}
        if all(v == state for v in states.values()):
            return states
        if time.monotonic() > deadline:
            raise AssertionError(f"{host.name}: pressure states {states}, not {state}")


def mh_spill_case(a, b, admin_a: int, admin_b: int, buf: bytes, want: dict) -> dict:
    """(d): A at the critical rung (memory.rss); its batch-class requests
    answer 200 from B, then with B critical too, A sheds 503 and nothing
    ping-pongs."""
    mh_arm(a, "memory.rss=error", 2)
    _, a0 = mh_stats(a)
    _, b0 = mh_stats(b)
    spilled, shed = list(MH_SPILL[:4]), list(MH_SPILL[4:])
    for w in spilled:
        status, _, body, _ = mh_post(a.port, mh_path(w) + "&key=bulk-key", buf)
        if status != 200 or body != want[w]:
            raise AssertionError(f"A at critical, /resize?width={w}&key=bulk-key: {status}, "
                                 f"byte-equal {body == want[w]}")
    _, a1 = mh_stats(a)
    _, b1 = mh_stats(b)
    spills = a1["spills"] - a0["spills"]
    if spills != len(spilled) or b1["served_for_peer"] - b0["served_for_peer"] < spills:
        raise AssertionError(f"{spills} spills of {len(spilled)}, B served "
                             f"{b1['served_for_peer'] - b0['served_for_peer']}")
    mh_arm(b, "memory.rss=error", 2)
    base_b = f"http://127.0.0.1:{admin_b}"
    deadline = time.monotonic() + MH_CONVERGE_S
    while mh_cluster(admin_a)["peers"][base_b]["state"]["pressure_level"] < 2:
        if time.monotonic() > deadline:
            raise AssertionError("A's gossip never read B at the critical rung")
        time.sleep(0.3)
    time.sleep(1.0)  # A's workers' own gossip
    statuses = []
    for w in shed:
        status, headers, _, _ = mh_post(a.port, mh_path(w) + "&key=bulk-key", buf)
        statuses.append(status)
        if status != 503 or "Retry-After" not in headers:
            raise AssertionError(f"A and B critical, /resize?width={w}: {status}")
    _, a2 = mh_stats(a)
    _, b2 = mh_stats(b)
    if a2["spills"] != a1["spills"] or b2["served_for_peer"] != b1["served_for_peer"]:
        raise AssertionError(f"with both critical: spills {a2['spills'] - a1['spills']}, B "
                             f"served {b2['served_for_peer'] - b1['served_for_peer']}")
    out = {"spills": spills, "spilled": len(spilled), "shed": statuses,
           "spill_fails": a2["spill_fails"] - a0["spill_fails"]}
    log(f"  (d) A critical: {spills} of {len(spilled)} batch-class requests answered 200 by B, "
        f"byte-equal; A and B critical: {statuses}, no spill, B served nothing more")
    return out


def multihost_phase(smi: str) -> dict:
    """Phase 21 (see the module docstring): two hosts of the port, each a
    --workers 2 supervisor with its admin plane, on the one card, and one
    process for the answers they must equal."""
    import collections

    t0 = time.perf_counter()
    with open(LARGE_JPG, "rb") as f:
        buf = f.read()
    if DEVICE != "cpu":
        import torch

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    base_mib, base_apps = device_used_mib(), compute_apps()
    port_a, port_b, admin_a, admin_b = (free_port() for _ in range(4))

    def make_b():
        return mh_host("mh_host_b", "host-b", port_b, admin_b, admin_a)

    pending = {"a": booting(lambda: mh_host("mh_host_a", "host-a", port_a, admin_a, admin_b)),
               "b": booting(make_b)}
    launches: collections.Counter = collections.Counter()
    hosts: dict = {}
    out: dict = {}
    try:
        single = ServerProcess("mh_single", [])
        try:
            want = {}
            for w in list(MH_HUNT) + list(MH_BURST) + list(MH_AFTER) + list(MH_RESUME) \
                    + list(MH_SPILL):
                status, _, body = http(single.port, mh_path(w), buf)
                if status != 200:
                    raise AssertionError(f"one process: /resize?width={w} {status}")
                want[w] = body
            launches.update(single.health()["kernelLaunches"])
        finally:
            single.stop()
        hosts["a"] = pending.pop("a")()
        hosts["b"] = pending.pop("b")()
        a, b = hosts["a"], hosts["b"]
        out["boot_s"] = {"a": a.boot_s, "b": b.boot_s}
        view = mh_wait_peer(admin_a, "host-b")
        mh_wait_peer(admin_b, "host-a")
        if not view["hosts"]["host-a"]["local"]:
            raise AssertionError(f"A's cluster view: {view['hosts']}")
        out["converge_s"] = time.perf_counter() - t0
        out["warm"] = {"a": mh_warm(a, buf), "b": mh_warm(b, buf)}
        time.sleep(1.0)  # each worker's own gossip has crossed too
        out["forward"] = mh_forward_case(a, b, buf, want, smi, base_mib, base_apps)
        old_epoch = int(out["forward"]["identities"]["b"].rsplit(":", 1)[1])
        launches.update(b.launches())
        hosts.pop("b")
        out["failopen"] = mh_failopen_case(a, b, buf, want)
        out["restart"], hosts["b"] = mh_restart_case(a, admin_a, make_b, old_epoch, buf, want)
        out["spill"] = mh_spill_case(a, hosts["b"], admin_a, admin_b, buf, want)
    finally:
        for join in pending.values():
            try:
                join().stop()
            except Exception as e:  # the step's own error is the one raised
                log(f"  a host's boot failed too: {e}")
        for host in hosts.values():
            host.stop()
            launches.update(host.launches())
    out["launches"] = {k: launches.get(k, 0) for k in KERNEL_ROWS}
    if DEVICE != "cpu":
        for name in CONFIG1_KERNELS:
            if out["launches"][name] <= 0:
                raise AssertionError(f"kernel {name} was not launched in phase 21")
    out["seconds"] = time.perf_counter() - t0
    log(f"  launches_multihost (one process and every worker of both hosts, by /health): "
        f"{out['launches']}; phase 21: {out['seconds']:.1f} s")
    return out


# --- phase 2b: the host codec against digests pinned from the JAX package ---

CODEC_SEED = 27
CODEC_DIMS = (240, 320)  # (h, w) of the seeded frames
# sha256 of each case (`codec_digests`): GIF bytes, else (h, w, c) and the
# decoded pixels. tests/test_torch_native_codecs.py holds them equal to the
# JAX package's native codec on the CPU.
CODEC_DIGESTS = {
    "gif-rgb": "98ff3936c083adfbd4db8fb96300704367be5cb71c79ce26c6337106b1c79399",
    "gif-rgba": "7485fff157ff67326de1b19d62108341588c5962a95be317370a5a76309c182a",
    "png-rgba": "4c5a21769d22934ae8d1b7345619119ebb9ad29d49c5e4c96671efbee6cf2f98",
    "png-palette-rgb": "68cedde084e7175685e8ca62f6f37dafe96aa50a3f053e323c3692932170a2a2",
    "png-palette-rgba": "eee6c11eee0e11c35ce31006408a89b8847f995525488ba8e2c6b9d2edf3b26f",
    "png16-rgba-gama": "c83c9d90c2395ecfbf6fcbeb5700362b7b6ac5ab4942d7944a086cd150433ca4",
    "tiff-rgba": "4c5a21769d22934ae8d1b7345619119ebb9ad29d49c5e4c96671efbee6cf2f98",
    "tiff16-gray": "426daff8718e347b6fe4cabd468793e36a31cf17352b804627dc46a5c8549827",
}
# a lossy case's (h, w, c) after an encode and decode
CODEC_WEBP_SHAPES = {"webp-q50-rgb": [240, 320, 3], "webp-q90-rgba": [240, 320, 4]}
# The 16-bit PNGs without a gAMA chunk: libpng's simplified reader takes
# their samples as linear light and converts them to 8-bit sRGB, and that
# rounding moved by 1 LSB on a few samples between its releases (1.6.39
# against 1.6.53 and 1.6.56). So their decoded pixels (16x16 frames) are
# pinned whole, base64 of the (h, w, c) uint8 array the JAX package gives
# with libpng CODEC_LIBPNG_PIN: exact where the port links that release,
# within 1 LSB elsewhere, the differing samples counted.
CODEC_LIBPNG_PIN = 10639
CODEC_PIXEL_SHAPES = {"png16-rgb": (16, 16, 3), "png16-gray-alpha": (16, 16, 4)}
CODEC_PIXELS = {
    "png16-rgb": (
        "eP+S11VB03Ta1bHqqvCym8zwyf7nd/lWct9tvbD0sserrfivVLY9peJfzcO9x+HvKc+c9bf+86vH4tnY"
        "wIekw0N20+dbzsTLXIUilLxziX/qfOx0RMvHsNEe/HwGvcz0lcE/w/qrzpjybj12gLV5nLtTvMGvsXjr"
        "TPnaPLbxSd7LzeHjfXLypL+Y4dTpb7DPloibnC3P8pa+pZSvsy7T9/6OzevvCqvr88bKjsrXxZTHj6O8"
        "38f9s/i+7O5V6O/QxMTUDJyMKrzn0Bfx/PW3eEfKt+LYgKr3omjN6JyM27GwcpvZZU3G+87R/ejM/sbS"
        "w2bUtpI72ffb0Vz8dMHElYrcRuz+kJeUe9zGn/W80q2Z6XnUZ+jVgeSlNYpG88ikdi7F+tPJ6ri/a43+"
        "5xyv8ODc9KJd+MFxv4GWcYrFevXwL82WF4TjbWAlav38cnadtIXmgWP0oeDojdqppKScjXvF7Mi46XJA"
        "+cmhT4vDxvRQwO7S8fb+//CV7GG5gK/f+O24n9fav7nh6ivmutjuzNa5wsbxR5y4mMqS4bO3QjY2qJ73"
        "Z/r7eN+bY9381tmPcIjb0Gvh/s5qfNDqc+DiycVfx3p8sGmxhzOixJmv+jGGyELEZMbyw3nsbW6u2HF8"
        "5G+mytKu5d647iy6tWjN7Ln3be+7sPbC1Oj0XOX2/vrB+z5NgPKyrqqa54CmI6DmzdFvXPBomRVF/Haj"
        "fNrNdeyMsd7iruLJ55l8YmmWbvOjfpnnz6u5xsWyv99Jmpjn7tZZ9ayny+LlqlJh+WP15JJge/xn/Md3"
        "vpO+n8+14ax092ekppOYp9Gj/LqQ+OTl3M2ueEaj0WuxINabjpi7up6IV7DQl3K9Q+KNvBPKy+WEkrun"
        "nq/GQ3yomVLgz/L6qN7vzvQ2iu72/66ScePpet1Zx7pV2NEt3tPJebnvgff58Nrb5ny8tj2sKuyWo9m4"
        "7KfA7YnIbeC4fIjkooOd/07lKCznnGxDq4yKa163rPx10OrDu/D1zMh90I252l/y"
    ),
    "png16-gray-alpha": (
        "eHh4/tfX1xfT09Mt1dXVcqqqqt+bm5ucycnJ/Xd3d/JycnK9vb29cbKyspOtra3xVFRUeqWlpcPNzc2O"
        "x8fHwikpKaH19fV78/PzaeLi4rLAwMA/w8PDDtPT083Ozs6PXFxcPZSUlIKJiYk3fHx81kRERJqwsLCk"
        "/Pz8Nb29vZyVlZWLw8PD9M7OzlFubm4LgICAeJycnIG8vLyKsbGxMUxMTPI8PDx6SUlJvc3NzcN9fX0s"
        "pKSkiOHh4atvb29xlpaWQJycnAby8vJQpaWlTbOzswb39/f+zc3N1QoKCmrz8/OTjo6OmMXFxU2Pj49f"
        "39/flLOzs/Hs7Ozb6Ojo3cTExI4MDAxWKioqg9DQ0AH8/PzpeHh4D7e3t8SAgIBpoqKiI+jo6Ffb29tz"
        "cnJyVWVlZRL7+/uf/f39z/7+/pLDw8Mitra2S9nZ2e3R0dEbdHR0ipWVlUJGRkbWkJCQUHt7e7ifn5/p"
        "0tLSbenp6TJnZ2fOgYGBxjU1NULz8/OVdnZ2Bvr6+qnq6up8a2trRefn5wLw8PC/9PT0Xvj4+Iq/v785"
        "cXFxQnp6eukvLy+eFxcXPG1tbR5qamr8cnJyL7S0tD2BgYEgoaGhv42NjbSkpKRgjY2NNOzs7JXp6ekr"
        "+fn5mE9PT0TGxsbowMDA2/Hx8e3////g7OzsH4CAgHD4+Pjan5+fr7+/v37q6uoFurq6sczMzK3CwsKT"
        "R0dHV5iYmJjh4eF1QkJCCKioqFlnZ2fzeHh4vmNjY7nW1tazcHBwQNDQ0Cb+/v6gfHx8pHNzc8DJycmQ"
        "x8fHMrCwsCSHh4cIxMTEU/r6+gfIyMgNZGRkksPDwzFtbW0o2NjYKuTk5CnKysqm5eXlvO7u7gW1tbUk"
        "7Ozsfm1tbd2wsLDr1NTU0FxcXMj+/v70+/v7C4CAgOSurq5o5+fnOCMjI1vNzc2lXFxc35mZmQH8/Pwv"
        "fHx8tXV1ddexsbG9rq6uw+fn51NiYmIkbm5u5n5+flPPz89rxsbGkb+/v76amppS7u7urvX19WvLy8vE"
        "qqqqFfn5+SDk5ORLe3t7+fz8/JW+vr5Mn5+fouHh4Wv39/cjpqamTKenp6T8/Px/+Pj4x9zc3J14eHgP"
        "0dHRJiAgIK6Ojo5Surq6WFdXV3GXl5csQ0NDxLy8vAHLy8vJkpKSgZ6ennBDQ0M0mZmZFc/Pz+OoqKi8"
        "zs7O5oqKitv///9vcXFxxnp6ervHx8d/2NjYpd7e3qd5eXl+gYGB7/Dw8LXm5uY0tra2CyoqKtijo6Oz"
        "7OzsZe3t7UFtbW3AfHx8QKKiojv///8TKCgoBZycnCerq6tEa2trHKysrPnQ0NDTu7u738zMzJbQ0NBG"
        "2traHQ=="
    ),
}


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    import struct
    import zlib

    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png16(a, gamma: int = 0) -> bytes:
    """A non-interlaced 16-bit PNG of uint16 a [H, W, C] (C = 1 gray, 2
    gray + alpha, 3 RGB, 4 RGBA), with a gAMA chunk of `gamma` (in
    1/100000) when it is not 0."""
    import struct
    import zlib

    h, w, c = a.shape
    raw = b"".join(b"\x00" + a[y].astype(">u2").tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 16, {1: 0, 2: 4, 3: 2, 4: 6}[c], 0, 0, 0)
    gama = _png_chunk(b"gAMA", struct.pack(">I", gamma)) if gamma else b""
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr) + gama
            + _png_chunk(b"IDAT", zlib.compress(raw)) + _png_chunk(b"IEND", b""))


def tiff_bytes(a) -> bytes:
    """An uncompressed little-endian TIFF of a [H, W, C] (uint8 or
    uint16; C = 1 gray, 3 RGB, 4 RGBA with unassociated alpha)."""
    import struct

    h, w, c = a.shape
    bits = a.dtype.itemsize * 8
    data = a.astype(f"<u{a.dtype.itemsize}").tobytes()
    # BitsPerSample holds one value inline, else points past the strip
    tags = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, c, bits if c == 1 else 8 + len(data)),
            (259, 3, 1, 1), (262, 3, 1, 1 if c == 1 else 2), (273, 4, 1, 8),
            (277, 3, 1, c), (278, 4, 1, h), (279, 4, 1, len(data))]
    if c == 4:
        tags.append((338, 3, 1, 2))
    body = data + (struct.pack(f"<{c}H", *[bits] * c) if c > 1 else b"")
    ifd = struct.pack("<H", len(tags)) + b"".join(
        struct.pack("<HHII", *t) for t in tags) + struct.pack("<I", 0)
    return b"II*\x00" + struct.pack("<I", 8 + len(body)) + body + ifd


def codec_frames() -> dict:
    """The seeded frames of the codec check: a smooth 320x240 RGBA frame
    (an alpha ramp across it, alpha under 128 on its left half) with noise
    of +-6, its RGB part, and 16-bit noise."""
    import numpy as np

    rng = np.random.default_rng(CODEC_SEED)
    h, w = CODEC_DIMS
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (w + h),
                     xx * 255 // (w - 1)], axis=-1)
    rgba = np.clip(base + rng.integers(-6, 7, size=base.shape), 0, 255).astype(np.uint8)
    rgba[..., 3] = base[..., 3]
    return {"rgba": rgba, "rgb": np.ascontiguousarray(rgba[..., :3]),
            "u16": rng.integers(0, 65536, size=(h // 4, w // 4, 4), dtype=np.uint16)}


def codec_digests(ext) -> tuple:
    """(digests, webp shapes, pixels) of the codec cases through `ext`, a
    native codec module with the JAX package's interface (the port's
    `_itpu_torch_codecs` or the JAX package's `_imaginary_codecs`): decode
    (bytes, fmt) and encode(buf, h, w, c, fmt, quality, compression,
    progressive, palette, speed). pixels holds CODEC_PIXEL_SHAPES' cases
    as uint8 arrays."""
    import numpy as np

    def enc(a, fmt, quality=80, interlace=0, palette=0, speed=0):
        h, w, c = a.shape
        return ext.encode(np.ascontiguousarray(a), h, w, c, fmt, quality, 6,
                          interlace, palette, speed)

    def pixels(buf, fmt):
        data, h, w, c, _, _ = ext.decode(buf, fmt)
        return [h, w, c], data

    def digest(buf, fmt):
        shape, data = pixels(buf, fmt)
        return hashlib.sha256(repr(shape).encode() + data).hexdigest()

    f = codec_frames()
    u16 = f["u16"]
    out = {
        "gif-rgb": hashlib.sha256(enc(f["rgb"], "gif")).hexdigest(),
        "gif-rgba": hashlib.sha256(enc(f["rgba"], "gif")).hexdigest(),
        "png-rgba": digest(enc(f["rgba"], "png"), "png"),
        "png-palette-rgb": digest(enc(f["rgb"], "png", palette=1), "png"),
        "png-palette-rgba": digest(enc(f["rgba"], "png", interlace=1, palette=1, speed=5),
                                   "png"),
        "png16-rgba-gama": digest(png16(u16, gamma=45455), "png"),
        "tiff-rgba": digest(enc(f["rgba"], "tiff"), "tiff"),
        "tiff16-gray": digest(tiff_bytes(u16[..., :1]), "tiff"),
    }
    webp = {"webp-q50-rgb": pixels(enc(f["rgb"], "webp", quality=50), "webp")[0],
            "webp-q90-rgba": pixels(enc(f["rgba"], "webp", quality=90), "webp")[0]}
    pix = {}
    for name, a in (("png16-rgb", u16[:16, :16, :3]), ("png16-gray-alpha", u16[:16, :16, :2])):
        shape, data = pixels(png16(a), "png")
        pix[name] = np.frombuffer(data, np.uint8).reshape(shape)
    return out, webp, pix


def pinned_pixels(name: str):
    """CODEC_PIXELS[name] as its uint8 array."""
    import base64

    import numpy as np

    return np.frombuffer(base64.b64decode(CODEC_PIXELS[name]), np.uint8).reshape(
        CODEC_PIXEL_SHAPES[name])


def codec_phase() -> dict:
    """The port's native codec on the seeded cases against the JAX
    package's answers on the CPU; a mismatch fails the run."""
    import numpy as np

    from imaginary_tpu_torch.codecs import native_backend

    t0 = time.perf_counter()
    ext = native_backend.extension()
    got, webp, pix = codec_digests(ext)
    bad = sorted(k for k in CODEC_DIGESTS if got.get(k) != CODEC_DIGESTS[k])
    if bad or set(got) != set(CODEC_DIGESTS):
        raise AssertionError(f"host codec digests differ from the JAX package's: {bad} "
                             f"(got {got})")
    if webp != CODEC_WEBP_SHAPES:
        raise AssertionError(f"WEBP round trips {webp}, want {CODEC_WEBP_SHAPES}")
    lsb = 0 if ext.LIBPNG == CODEC_LIBPNG_PIN else 1
    linear = {}
    for name in CODEC_PIXEL_SHAPES:
        want = pinned_pixels(name)
        if pix[name].shape != want.shape:
            raise AssertionError(f"{name}: {pix[name].shape}, want {want.shape}")
        d = np.abs(pix[name].astype(np.int16) - want)
        linear[name] = {"max_abs": int(d.max()), "differing": int((d > 0).sum()),
                        "samples": int(d.size)}
        if d.max() > lsb:
            raise AssertionError(f"{name}: {linear[name]} against the JAX package's pixels "
                                 f"(libpng {ext.LIBPNG}, pinned with {CODEC_LIBPNG_PIN}; "
                                 f"bound {lsb} LSB)")
    secs = time.perf_counter() - t0
    log(f"  host codec: {len(got)} digests equal to the JAX package's "
        f"({', '.join(sorted(got))}); WEBP {webp}; 16-bit linear PNGs against the JAX "
        f"package's pixels (libpng {ext.LIBPNG}, pinned with {CODEC_LIBPNG_PIN}, bound "
        f"{lsb} LSB): {linear}; {secs:.2f} s")
    return {"digests": got, "webp": webp, "linear_png16": linear, "libpng": ext.LIBPNG,
            "seconds": secs}


# --- phase 2c: hostile bytes through the host codec -------------------------

ROBUST_SEED = 11
ROBUST_FORMATS = ("jpeg", "png", "webp", "gif", "tiff")
ROBUST_DIMS = (64, 96)  # (h, w) of the seeded frame each format encodes
ROBUST_HEAD = 64  # every cut inside the first ROBUST_HEAD bytes
ROBUST_BODY_CUTS = 180  # then cuts at this many strides through the body
ROBUST_FLIPS = 1500  # seeded mutations a format, each of 1-3 flipped bits
ROBUST_TIMEOUT_S = 300  # the child's limit: a hang is a failure too
ROBUST_EXAMPLES = 5  # "other" outcomes kept a format, for the log


def robustness_sweep(flips: int = ROBUST_FLIPS, body_cuts: int = ROBUST_BODY_CUTS) -> dict:
    """Truncations and seeded bit flips of a seeded frame in each of
    ROBUST_FORMATS through the port's `codecs.decode` and `codecs.probe`
    (and, for the JPEG, `codecs.probe_fast` and `decode_yuv420` at the
    frame's bucket): {format: counts of results, ImageErrors and anything
    else}. A decode that returns something other than a 3-D array counts
    as something else. The contract is a result or an ImageError; a crash
    ends the process, which is why phase 2c runs this in a child."""
    import numpy as np

    from imaginary_tpu_torch import codecs
    from imaginary_tpu_torch.codecs import EncodeOptions
    from imaginary_tpu_torch.errors import ImageError
    from imaginary_tpu_torch.imgtype import ImageType
    from imaginary_tpu_torch.ops.buckets import bucket_shape

    rng = np.random.default_rng(ROBUST_SEED)
    h, w = ROBUST_DIMS
    frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    hb, wb = bucket_shape(h, w)

    def decode(buf):
        if codecs.decode(buf, 1).array.ndim != 3:
            raise TypeError("decode returned an array that is not 3-D")

    def decode_yuv420(buf):
        codecs.decode_yuv420(buf, 1, hb, wb)

    def tally(counts, fn, *args):
        try:
            fn(*args)
            counts["results"] += 1
        except ImageError:
            counts["image_errors"] += 1
        except Exception as e:  # the contract's breach, counted and kept
            counts["other"] += 1
            if len(counts["examples"]) < ROBUST_EXAMPLES:
                counts["examples"].append(f"{fn.__name__}: {type(e).__name__}: {e}"[:200])

    out = {}
    for fmt in ROBUST_FORMATS:
        buf = codecs.encode(frame, EncodeOptions(type=ImageType(fmt), quality=85))
        if codecs.decode(buf, 1).array.shape[:2] != (h, w):
            raise AssertionError(f"{fmt}: the intact encode does not decode to {(h, w)}")
        fns = [decode, codecs.probe]
        if fmt == "jpeg":
            fns += [codecs.probe_fast, decode_yuv420]
        cuts = list(range(min(len(buf), ROBUST_HEAD)))
        cuts += list(range(ROBUST_HEAD, len(buf), max(1, len(buf) // body_cuts)))
        counts = {"bytes": len(buf), "truncations": len(cuts), "flips": flips,
                  "calls": 0, "results": 0, "image_errors": 0, "other": 0, "examples": []}
        t0 = time.perf_counter()
        for cut in cuts:
            for fn in fns:
                tally(counts, fn, buf[:cut])
        for _ in range(flips):
            m = bytearray(buf)
            for _ in range(int(rng.integers(1, 4))):
                m[int(rng.integers(0, len(m)))] ^= 1 << int(rng.integers(0, 8))
            for fn in fns:
                tally(counts, fn, bytes(m))
        counts["calls"] = counts["results"] + counts["image_errors"] + counts["other"]
        counts["seconds"] = time.perf_counter() - t0
        out[fmt] = counts
    return out


def robustness_phase() -> dict:
    """Phase 2c: `robustness_sweep` in a child process on this machine's
    build of the host codec (on the card machine, the wheel's libraries
    with the vendored headers), so a crash or a hang is a failed phase
    with its exit status. Fails on any outcome other than a result or an
    ImageError."""
    from imaginary_tpu_torch.codecs import native_backend

    t0 = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    err_path = os.path.join(OUT_DIR, "robustness.err")
    code = "import json, chip_smoke; print(json.dumps(chip_smoke.robustness_sweep()))"
    with open(err_path, "w") as err:  # libjpeg's warnings, one a truncation
        try:
            proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                                  stderr=err, text=True, timeout=ROBUST_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"the robustness sweep hung past {ROBUST_TIMEOUT_S} s")
    if proc.returncode != 0:
        with open(err_path) as f:
            tail = f.read()[-2000:]
        raise AssertionError(f"the robustness sweep's child exited {proc.returncode} "
                             f"(a negative status is the signal that ended it): {tail}")
    sweep = json.loads(proc.stdout.strip().splitlines()[-1])
    linked = native_backend.linked()
    for fmt, c in sweep.items():
        log(f"  {fmt}: {c['truncations']} truncations, {c['flips']} flips, {c['calls']} calls: "
            f"{c['results']} results, {c['image_errors']} ImageErrors, {c['other']} other "
            f"({c['bytes']} B, {c['seconds']:.2f} s)"
            + (f"; {c['examples']}" if c["examples"] else ""))
    bad = {fmt: c["examples"] for fmt, c in sweep.items() if c["other"]}
    if bad:
        raise AssertionError(f"outcomes other than a result or an ImageError: {bad}")
    secs = time.perf_counter() - t0
    log(f"  codec linked {linked}; phase 2c: {secs:.1f} s (the child's interpreter included)")
    return {"formats": sweep, "linked": linked, "seconds": secs}


# the keys of a W-shard form's timing that the kernels line carries
SHARD_FORM_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shards",
                   "shard_shape", "ms_over_whole", "max_abs_err")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    import numpy as np

    from imaginary_tpu_torch import kernels  # fails outside the repository
    from imaginary_tpu_torch.native import build as native_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report: dict = {"phase_seconds": {}}
    marks = [("", time.perf_counter())]

    def phase_log(header: str) -> None:
        """The phase before's seconds, then the next phase's header."""
        now = time.perf_counter()
        if marks[-1][0]:
            report["phase_seconds"][marks[-1][0]] = now - marks[-1][1]
            log(f"  ({marks[-1][0]}: {now - marks[-1][1]:.1f} s)")
        marks.append((header.split(":")[0].lstrip("= "), now))
        log(header)

    def step(label: str, fn, *args):
        """fn(*args), its seconds logged and kept beside the phases'."""
        t = time.perf_counter()
        out = fn(*args)
        report["phase_seconds"][label] = time.perf_counter() - t
        log(f"  ({label}: {report['phase_seconds'][label]:.1f} s)")
        return out

    gc.callbacks.append(gc_pause)
    smi = smi_line()
    phase_log("== phase 1: environment")
    log(f"  {smi}")
    log(f"  python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    report["env"] = {"smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda}

    phase_log("== phase 2: build")
    codec_box: dict = {}

    def build_codec():
        try:
            codec_box["result"] = native_build.build()
            codec_box["entropy"] = native_build.build_entropy()
        except Exception as e:  # re-raised below, in the main thread
            codec_box["error"] = e

    t0 = time.monotonic()
    tc = threading.Thread(target=build_codec)
    tc.start()
    built = kernels.load_all()
    tc.join()
    if "error" in codec_box:
        raise codec_box["error"]
    log(f"  kernels: {time.monotonic() - t0:.1f} s wall for "
        + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in built.items()))
    _, codec_secs, _ = codec_box["result"]
    from imaginary_tpu_torch.codecs import native_backend

    codec_ext = native_backend.extension()
    log(f"  native codec: {codec_secs:.1f} s, FORMATS {codec_ext.FORMATS}; linked: "
        f"{codec_ext.LINKED}")
    from imaginary_tpu_torch.codecs import jpeg_dct

    _, entropy_secs = codec_box["entropy"]
    arm = jpeg_dct.decoder_name()
    log(f"  native entropy codec: {entropy_secs:.1f} s, dct decode arm: {arm}")
    if arm != "native":
        raise AssertionError(f"the entropy codec resolved to the {arm} arm")
    report["build"] = {k: {"seconds": v["seconds"], "log": v["log"]} for k, v in built.items()}
    report["build"]["codec"] = {"seconds": codec_secs, "formats": codec_ext.FORMATS,
                                "linked": native_backend.linked()}
    report["build"]["entropy"] = {"seconds": entropy_secs, "arm": arm}
    phase_log("== phase 2b: the host codec against the JAX package's digests")
    report["codec"] = codec_phase()
    phase_log("== phase 2c: truncations and bit flips through the host codec, in a child")
    report["robustness"] = robustness_phase()

    rng = np.random.default_rng(SEED)
    phase_log("== phase 3: kernels against their plain versions")
    report["kernels"] = step("kernel_phase", kernel_phase, rng)
    step("orient_phase", orient_phase, report["kernels"])
    step("config2_kernel_phase", config2_kernel_phase, rng, report["kernels"])
    step("config3_kernel_phase", config3_kernel_phase, report["kernels"])
    step("pack_gray_phase", pack_gray_phase, report["kernels"])
    step("out_param_phase", out_param_phase, report["kernels"])
    step("seams_phase", seams_phase, report["kernels"])
    step("config4_kernel_phase", config4_kernel_phase, report["kernels"])
    step("dct_kernel_phase", dct_kernel_phase, report["kernels"])
    phase_log("== phase 4: main path through the server")
    unwatch = watch_servers()
    report["main_path"] = main_path_phase()
    t0 = time.perf_counter()
    png = make_4k_png()
    log(f"  config 3's 3840x2160 PNG: {len(png)} bytes, made in "
        f"{time.perf_counter() - t0:.2f} s")
    phase_log("== phase 4b/5: cuda against cpu (run_single; run_batch B=16, B=32, B=1 and B=8)")
    report["parity"] = parity_phase(rng, png)
    phase_log("== phase 6: config 2 under load (/thumbnail, /crop, /rotate, EXIF /resize)")
    report["config2"] = config2_phase()
    phase_log("== phase 7: config 3 (/pipeline on a 4K PNG to WEBP), the JPEG /pipeline, bw")
    report["config3"] = config3_phase(png)
    t0 = time.perf_counter()
    stream = make_config4_stream()
    phase_log(f"== phase 8: config 4 (/smartcrop on bench_firehose.py's stream; made in "
        f"{time.perf_counter() - t0:.2f} s)")
    report["config4"] = config4_phase(stream)
    phase_log("== phase 9: the DCT transport both ways (/resize at k = 2 and k = 8; a "
              "restart-segmented 48 MP /resize on the native, numpy and python arms)")
    report["dct"] = dct_phase(png)
    phase_log("== phase 10a: the W-sharded blur (K13) and its halo exchange")
    report["sharded_blur"] = sharded_blur_phase(report["kernels"])
    phase_log("== phase 10b/c: multi-GPU lanes (--mesh-policy lanes; four lanes on one "
        "card, lanes and sharded; chip_error[1] failover)")
    report["mesh_lanes"] = mesh_lanes_phase()
    phase_log(f"== phase 10d: the spatial route (config 3's /pipeline and the bw chain on the "
        f"4K PNG; the JPEG chains on it as a 4:2:0 JPEG; the dct transport's chains at "
        f"every layout and k = 4; W-sharded over {SPATIAL_SHARDS} entries of one card)")
    report["spatial"] = spatial_route_phase(png, report["kernels"])
    phase_log("== phase 11: the HTTP layer on the card (config 1 with the reference's "
        "middleware chain, /info, /metrics, a placeholder, the throttle)")
    report["http"] = http_layer_phase()
    phase_log("== phase 12: URL sources and watermarkImage on the card (config 1 over ?url=, "
        "the placed K7, the source's statuses, config 5's stream over ?url=)")
    report["url"] = url_source_phase(png, stream)
    phase_log("== phase 13: --prewarm and the cold server's compile misses, the request "
        "deadline on the card, the golden matrix on the card")
    report["prewarm"] = step("prewarm_phase", prewarm_phase, smi)
    report["deadline"] = step("deadline_phase", deadline_phase, smi)
    report["golden"] = step("golden_phase", golden_phase)
    report["chain_plain"] = step("chain_plain_phase", chain_plain_phase, png)
    report["listed_bounds"] = step("listed_bounds", listed_bounds)
    unwatch()
    phase_log("== phase 14: the fault domain and the host placement (integrity, OOM, the "
        "drain watchdog, hedging, fail-slow, --force-host)")
    report["fault_domain"] = fault_domain_phase(smi)
    phase_log("== phase 15: the executor's admission half (convoy, the governor's byte cap, "
        "qos, donation, WIRE and the arena, the drain)")
    report["admission"] = admission_phase(smi, png)
    phase_log("== phase 16: the cache tiers (the result tier and 304, singleflight and the "
        "coalesce wait's deadline, the frame tier, the device tier on one card and on "
        "four lanes, the brownout, the source tier, phase 6's mix on lanes)")
    report["cache"] = cache_phase(smi, png)
    phase_log("== phase 17: the mesh (config 5's stream under --use-mesh, sharded lanes and "
        "unsharded on four entries of card 0; NCCL with a world of one; two "
        "--mesh-hosts processes)")
    report["mesh"] = mesh_phase()
    phase_log("== phase 18: the vector and HEIF/AVIF codecs (the loaders found, each route "
        "against the reference's rule, K1's launches)")
    report["vector"] = vector_phase()
    phase_log("== phase 19: the observability planes on the card (wide events, the SLO engine, "
        "the cost and capacity plane, /debugz/profile, the armed latency, h2, --read-timeout)")
    report["obs"] = obs_phase(smi)
    phase_log("== phase 20: the single-host fleet on the card (--workers 2 against one process, "
        "a SIGHUP roll, a SIGKILLed worker, the shm tier, the forward hop, the claims and "
        "the admin plane)")
    report["fleet"] = fleet_phase(smi)
    phase_log("== phase 21: two hosts on the card (two --workers 2 supervisors with --peers, "
        "--router and their admin planes: the cross-host hop, fail-open, a new "
        "incarnation, spillover)")
    report["multihost"] = multihost_phase(smi)

    phase_log("== kernels line")
    rows = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        per_case = report["kernels"][name]
        main_case = {"resample": "B1-resize", "yuv420_unpack": "B1",
                     "yuv420_pack": "B1", "gather": "B1-embed",
                     "orient": "B32-transpose", "blur": "B1-r4",
                     "composite": "B1-replicate-C3", "gray": "bw-route",
                     "saliency": "B1", "window_argmax": "B1",
                     "from_dct": "main-420-k2", "to_dct": "resize-208x304",
                     "blur_halo": "spatial-config3"}[name]
        m = per_case[main_case]
        # each kernel's launches come from the run of the path it serves
        path = {"blur": "config3", "composite": "config3", "gray": "spatial",
                "saliency": "config4", "window_argmax": "config4",
                "from_dct": "dct", "to_dct": "dct",
                "blur_halo": "spatial"}.get(name, "config2")
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": report[path]["launches"][name],
            "launches_path": path,
            "launches_config1": report["main_path"]["launches"][name],
            "launches_config2": report["config2"]["launches"][name],
            "launches_config3": report["config3"]["launches"][name],
            "launches_config4": report["config4"]["launches"][name],
            "launches_dct": report["dct"]["launches"][name],
            "launches_sharded_blur": report["sharded_blur"]["launches"][name],
            "launches_spatial": report["spatial"]["launches"][name],
            "launches_spatial_dct": report["spatial"]["dct"]["launches"][name],
            "launches_http": report["http"]["launches"][name],
            "launches_url": report["url"]["launches"][name],
            "launches_prewarm": report["prewarm"]["launches"][name],
            "launches_prewarm_dct": report["prewarm"]["dct"]["launches"][name],
            "launches_golden": report["golden"]["launches"][name],
            "launches_admission": report["admission"]["launches"][name],
            "launches_cache": report["cache"]["launches"][name],
            "launches_mesh": report["mesh"]["launches"][name],
            "launches_vector": report["vector"]["launches"][name],
            "launches_obs": report["obs"]["launches"][name],
            "launches_fleet": report["fleet"]["launches"][name],
            "launches_multihost": report["multihost"]["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in per_case.values()),
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            # the W-shard forms timed at phase 10(d)'s shards (the spatial
            # route's launches are in launches_spatial)
            "shard_forms": {c: {k: v[k] for k in SHARD_FORM_KEYS if k in v}
                            for c, v in per_case.items()
                            if c.startswith("spatial-") and "ms" in v},
            "case": main_case,
        })
        if name == "orient":  # the folded runs beside the one-stage main case
            rows[-1]["runs"] = {f"B32-{r}": {k: per_case[f"B32-{r}"][k] for k in RUN_KEYS}
                                for r, _ in ORIENT_RUNS}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    log(f"  total: {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
