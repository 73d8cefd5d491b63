"""k2_roofline.batch: the bound of the window's self-attention (valid queries and keys) over the
device seconds of K2's forward kernel (``flash_attention_fwd_kernel``), in %."""

from portbench.harness import readings

KERNELS = ("flash_attention_fwd_kernel",)


def read(ctx):
    return readings.roofline(ctx, readings.attention_bound_s(ctx), *KERNELS)
