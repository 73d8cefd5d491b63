"""k1_roofline.batch: K1's bound for the window's log-mel work over the device seconds of its
kernel (``stft_power_mel_log_kernel``), in %."""

from portbench.harness import readings

KERNELS = ("stft_power_mel_log_kernel",)


def read(ctx):
    return readings.roofline(ctx, readings.k1_bound_s(ctx), *KERNELS)
