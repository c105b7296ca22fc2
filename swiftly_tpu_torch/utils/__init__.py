"""Host-side utilities of the port: FLOP models, checkpointing, the
subgrid-stream spill cache and the profiling helpers (the JAX package's
``swiftly_tpu/utils``; its XLA compilation cache has no counterpart:
the port's nvcc builds are always cached, in ``ops/_build.py``)."""

from .checkpoint import (
    CorruptCheckpointError,
    checkpoint_generations,
    restore_backward_state,
    restore_streamed_backward_state,
    save_backward_state,
    save_streamed_backward_state,
    verify_checkpoint,
)
from .flops import (
    backward_batched_flops,
    backward_sampled_flops,
    bwd_column_pass_flops,
    bwd_fold_flops,
    column_pass_flops,
    fft_flops,
    forward_batched_flops,
    forward_sampled_flops,
    peak_tflops,
    sampled_facet_pass_flops,
)
from .profiling import (
    MemorySampler,
    collective_bytes_backward,
    collective_bytes_forward,
    column_collective_bytes,
    device_memory_stats,
    probe_hbm_bytes,
    trace,
)
from .spill import SpillCache, StreamMidPatch, spill_budget_bytes

__all__ = [
    "CorruptCheckpointError",
    "MemorySampler",
    "SpillCache",
    "StreamMidPatch",
    "backward_batched_flops",
    "backward_sampled_flops",
    "bwd_column_pass_flops",
    "bwd_fold_flops",
    "checkpoint_generations",
    "collective_bytes_backward",
    "collective_bytes_forward",
    "column_collective_bytes",
    "column_pass_flops",
    "device_memory_stats",
    "fft_flops",
    "forward_batched_flops",
    "forward_sampled_flops",
    "peak_tflops",
    "probe_hbm_bytes",
    "restore_backward_state",
    "restore_streamed_backward_state",
    "sampled_facet_pass_flops",
    "save_backward_state",
    "save_streamed_backward_state",
    "spill_budget_bytes",
    "trace",
    "verify_checkpoint",
]
