"""Host-side utilities of the port: FLOP models, checkpointing and the
subgrid-stream spill cache (the JAX package's ``swiftly_tpu/utils``, as
far as ported: its profiling helpers are ROADMAP A10, its compilation
cache A15)."""

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
from .spill import SpillCache, spill_budget_bytes

__all__ = [
    "CorruptCheckpointError",
    "SpillCache",
    "backward_batched_flops",
    "backward_sampled_flops",
    "bwd_column_pass_flops",
    "bwd_fold_flops",
    "checkpoint_generations",
    "column_pass_flops",
    "fft_flops",
    "forward_batched_flops",
    "forward_sampled_flops",
    "peak_tflops",
    "restore_backward_state",
    "restore_streamed_backward_state",
    "sampled_facet_pass_flops",
    "save_backward_state",
    "save_streamed_backward_state",
    "spill_budget_bytes",
    "verify_checkpoint",
]
