"""k2_roofline.request: k2_roofline.batch's arithmetic over a request cell's window."""

from portbench.harness import readings

KERNELS = ("flash_attention_fwd_kernel",)


def read(ctx):
    return readings.roofline(ctx, readings.attention_bound_s(ctx), *KERNELS)
