"""The port's engine: the micro-batch executor and its stage timing."""

from imaginary_tpu_torch.engine.executor import (
    MAX_BATCH,
    Executor,
    ExecutorConfig,
    ExecutorStats,
)

__all__ = ["MAX_BATCH", "Executor", "ExecutorConfig", "ExecutorStats"]
