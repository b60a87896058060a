"""The whole window's share of the card's float32 peak: the model's
operations of its training steps (counted from shapes by the cell's
model module, ``train_step_flops`` or ``eval_batch_flops``; PERF.md
lists the terms) over the window's seconds times 67 TFLOP/s, in %.
The peak is float32 outside the tensor cores (H100 SXM data sheet), as
the port keeps TF32 off."""

from __future__ import annotations

from harness.peaks import PEAK_FP32_FLOPS


def read(trace):
    if trace.window_s <= 0 or not trace.flops:
        return None
    return 100.0 * trace.flops / (trace.window_s * PEAK_FP32_FLOPS)
