"""peak_mem_gib.batch: ``torch.cuda.max_memory_allocated()`` over the window, in GiB."""


def read(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 2**30
