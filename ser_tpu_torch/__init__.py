"""PyTorch/CUDA port of ser_tpu, for one NVIDIA H100.

A second package beside ``ser_tpu``, which stays the reference: each ported
module mirrors its ``ser_tpu`` counterpart's path and is held against it on the
CPU, and each TPU kernel on the ported path is a CUDA kernel written for
Hopper (``ser_tpu_torch/csrc``). The package imports torch, numpy and scipy,
and nothing of JAX or of ``ser_tpu``. Entry points run on the CUDA card unless
the caller asks for the CPU (``SER_TORCH_DEVICE=cpu``).
"""

from ser_tpu_torch.domain import EmotionSegment, TimelineEntry, TranscriptWord

__version__ = "0.1.0"

__all__ = ["EmotionSegment", "TimelineEntry", "TranscriptWord", "__version__"]
