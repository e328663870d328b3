"""Typed HTTP errors (behavioral contract from error.go:12-67).

The port's own copy of `imaginary_tpu/errors.py`, trimmed to what the
port raises. `ImageError` carries a message and HTTP
status; it renders as `{"message": ..., "status": ...}` and clamps
out-of-range codes to 503.
"""

from __future__ import annotations

import json


class ImageError(Exception):
    """ref: error.go:30-56 (message newlines stripped, code clamped).

    `headers` ride onto the HTTP error response; `extra` adds keys to
    the JSON body (the deadline's stage and times)."""

    def __init__(self, message: str, code: int, headers: dict = None,
                 extra: dict = None):
        super().__init__(message)
        self.message = message.replace("\n", "")
        self.code = code
        self.headers = dict(headers) if headers else {}
        self.extra = dict(extra) if extra else {}

    def http_code(self) -> int:
        if 400 <= self.code <= 511:
            return self.code
        return 503

    def json_bytes(self) -> bytes:
        body: dict = {"status": self.code}
        if self.message:
            body = {"message": self.message, "status": self.code}
        if self.extra:
            body.update(self.extra)
        return json.dumps(body).encode()

    def __repr__(self) -> str:  # pragma: no cover
        return f"ImageError({self.message!r}, {self.code})"


def new_error(message: str, code: int, headers: dict = None) -> ImageError:
    return ImageError(message, code, headers=headers)


class DeadlineExceeded(ImageError):
    """The request's deadline expired after admission: a 504 whose body
    carries the stage, the elapsed time and the budget (deadline.py
    raises it at every hop it guards)."""

    def __init__(self, stage: str, elapsed_ms: float, budget_ms: float):
        super().__init__(
            f"request deadline exceeded at {stage}: elapsed "
            f"{elapsed_ms:.0f}ms of {budget_ms:.0f}ms budget",
            504,
            extra={
                "stage": stage,
                "elapsed_ms": round(elapsed_ms, 1),
                "budget_ms": round(budget_ms, 1),
            },
        )
        self.stage = stage


# Predefined errors (ref: error.go:12-28)
ErrNotFound = ImageError("Not found", 404)
ErrInvalidAPIKey = ImageError("Invalid or missing API key", 401)
ErrMethodNotAllowed = ImageError(
    "HTTP method not allowed. Try with a POST or GET method (-enable-url-source flag must be defined)", 405
)
ErrGetMethodNotAllowed = ImageError(
    "GET method not allowed. Make sure remote URL source is enabled by using the flag: -enable-url-source", 405
)
ErrUnsupportedMedia = ImageError("Unsupported media type", 406)
ErrOutputFormat = ImageError("Unsupported output image format", 400)
ErrEmptyBody = ImageError("Empty or unreadable image", 400)
ErrMissingParamFile = ImageError("Missing required param: file", 400)
ErrInvalidFilePath = ImageError("Invalid file path", 400)
ErrMissingImageSource = ImageError("Cannot process the image due to missing or invalid params", 400)
ErrNotImplemented = ImageError("Not implemented endpoint", 501)
ErrInvalidURLSignature = ImageError("Invalid URL signature", 400)
ErrURLSignatureMismatch = ImageError("URL signature mismatch", 403)
ErrResolutionTooBig = ImageError("Image resolution is too big", 422)
ErrEntityTooLarge = ImageError("Entity is too large", 413)
ErrInvalidImageURL = ImageError("Invalid image URL", 400)
