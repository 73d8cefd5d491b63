"""emotion2vec feature backend: the accurate-research profile's compute core.

Counterpart of ``ser_tpu/_internal/repr/emotion2vec_backend.py``, with the
same ``backend_id`` (``emotion2vec``). The model is data2vec 2.0 audio, which
runs through the port's ``Wav2Vec2Encoder`` with its layout's switches (a
stack of positional convs, prenet and trunk blocks in one stack), so the
chunked masked encode, its bf16 attention through kernel K2 and the float32
retry through K2-f32 are ``XlsrBackend``'s.

Weights, by the first route that applies:

1. a FunASR ``model.pt`` (``models/emotion2vec_convert.py``);
2. an HF wav2vec2 directory (``config.json``), through the XLS-R loader;
3. with ``SER_ALLOW_RANDOM_INIT=1`` (or ``init="random"``), seeded random
   weights: ``SER_RANDOM_INIT_SIZE=full`` builds ``Wav2Vec2Config()``, the
   XLS-R 300M layout, exactly as the JAX package does (not emotion2vec's
   stacked positional encoder), otherwise the tiny config;

else ``RuntimeDependencyError``. The staging roots are searched in hub
order: ``iic/*`` ids (published on ModelScope) look in the ModelScope root
first, other ids in the HF root first.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from ser_tpu_torch._internal.repr.encoder_backend import random_init_seed, resolve_local_model_dir
from ser_tpu_torch._internal.repr.wav2vec2_backend import XlsrBackend
from ser_tpu_torch._internal.runtime.errors import RuntimeDependencyError
from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch.models import wav2vec2
from ser_tpu_torch.models.emotion2vec_convert import load_funasr_emotion2vec_state

logger = get_logger(__name__)

BACKEND_ID = "emotion2vec"


class Emotion2VecBackend(XlsrBackend):
    """emotion2vec-class encoder backend (backend_id ``emotion2vec``)."""

    def __init__(
        self,
        *,
        model_id: str,
        cache_root: Path,
        device: torch.device | str,
        modelscope_cache_root: Path | None = None,
        hub: str | None = None,
        dtype: str = "float32",
        init: str = "auto",
        config: wav2vec2.Wav2Vec2Config | None = None,
        state: dict[str, torch.Tensor] | None = None,
    ) -> None:
        # Set before the base constructor, which resolves the weights.
        self._modelscope_cache_root = Path(modelscope_cache_root) if modelscope_cache_root is not None else None
        self._hub = resolve_hub(model_id=model_id, hub=hub)
        super().__init__(
            model_id=model_id, cache_root=cache_root, device=device, dtype=dtype, init=init, config=config, state=state
        )

    def staging_roots(self, cache_root: Path) -> list[Path]:
        """The roots searched for local weights, in hub order."""
        roots = [Path(cache_root)]
        if self._modelscope_cache_root is not None:
            if self._hub == "ms":
                roots.insert(0, self._modelscope_cache_root)
            else:
                roots.append(self._modelscope_cache_root)
        return roots

    def _resolve_weights(self, cache_root: Path, model_id: str, init: str, config):
        roots = self.staging_roots(cache_root)
        model_dir = next(
            (found for root in roots if (found := resolve_local_model_dir(root, model_id)) is not None), None
        )
        allow_random = init == "random" or (init == "auto" and os.environ.get("SER_ALLOW_RANDOM_INIT", "") == "1")
        if model_dir is not None:
            if (model_dir / "model.pt").is_file():
                cfg, state = load_funasr_emotion2vec_state(model_dir)
                logger.info("Loaded %s FunASR/data2vec2 weights from %s", model_id, model_dir)
                return cfg, state
            cfg = wav2vec2.config_from_hf_dir(model_dir)
            state = wav2vec2.load_hf_wav2vec2_state(model_dir, cfg)
            logger.info("Loaded %s weights from %s", model_id, model_dir)
            return cfg, state
        if allow_random:
            if config is not None:
                cfg = config
            elif os.environ.get("SER_RANDOM_INIT_SIZE", "tiny") == "full":
                cfg = wav2vec2.Wav2Vec2Config()  # the JAX package's choice: XLS-R 300M's layout
            else:
                cfg = wav2vec2.Wav2Vec2Config.tiny()
            logger.warning("No local weights for %s; seeded random init (test mode).", model_id)
            state = wav2vec2.random_wav2vec2_state(cfg, seed=random_init_seed(BACKEND_ID, model_id), device=self._device)
            return cfg, state
        raise RuntimeDependencyError(
            f"No local weights for restricted backend {model_id!r} under "
            f"{[str(root) for root in roots]}. Stage the checkpoint locally after "
            "accepting its license (`ser configure --enable-backend emotion2vec`)."
        )

    @property
    def backend_id(self) -> str:
        return BACKEND_ID

    @property
    def hub(self) -> str:
        """The hub whose staging root is searched first (``ms`` or ``hf``)."""
        return self._hub


def resolve_hub(*, model_id: str, hub: str | None) -> str:
    """``ms`` or ``hf``: an explicit choice, else ModelScope for ``iic/*`` ids and HF otherwise."""
    if hub is not None:
        normalized = hub.strip().lower()
        if normalized in {"ms", "modelscope"}:
            return "ms"
        if normalized in {"hf", "huggingface"}:
            return "hf"
        raise ValueError("hub must be one of: ms, modelscope, hf, huggingface.")
    return "ms" if model_id.strip().lower().startswith("iic/") else "hf"


__all__ = ["BACKEND_ID", "Emotion2VecBackend", "resolve_hub"]
