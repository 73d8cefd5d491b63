"""The decode step's attention groups: kernels K3, K4 and K5 on the card.

Counterpart of ``ser_tpu/ops/decode_step_kernels.py``, with the same
functions, argument layouts and rounding points:

- ``ln_qkv_project`` (K3): float32 LayerNorm, then x·W_qkv + b (d → 3d);
- ``self_attend_and_out`` (K4): one query per (row, head) over the
  self-attention cache, keys ≤ ``position``, then the out-projection, bias and
  residual;
- ``cross_attention_step`` (K5): LayerNorm, per-head Q projection, one query
  over the encoder K/V, out-projection, bias and residual, and the float32
  attention weights (H, R, S) that the alignment heads record.

A CUDA tensor launches the kernel (``csrc/decode_step.cu``); a CPU tensor
takes the function's plain version (``*_reference``), which repeats the
kernel's arithmetic op for op in PyTorch. There is no other switch between the
two, and no fallback: a CUDA call that the kernel cannot take raises.

Rounding points (both versions): LayerNorm in float32; every product
accumulates in float32 and rounds to the weight dtype at its output; scores
are divided by ``sqrt(Dh)`` in the compute dtype and the softmax runs in
float32; P is normalised in float32, then cast to the compute dtype before
P·V; the out-projection sums per-head float32 partials in head order and rounds
once; bias and residual adds are in the compute dtype.

K4 and K5 launch one thread-block cluster per head and split the keys over its
CTAs (:func:`chunk_bounds`); the CTAs combine their softmax statistics, P·V
partials and (K5) Q-projection partials in rank order, so the sums' order is
fixed and the output is the same bits on every run. The JAX package updates
the K/V caches outside its kernels; here K3 can write them itself
(:func:`ln_qkv_project_to_cache`): the K and V parts of its output go into the
caches at ``position`` and only q comes back, the values those two scatters
would write.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ser_tpu_torch.ops import kernel_build

_NEG_INF = -1e30
_HEAD_DIM = 64
_TILE_COLS = 32
#: K4/K5's split (``csrc/decode_step.cu``: ``kMaxCluster``, ``kKeyAlign``): at most 8
#: CTAs per head, each taking a chunk of keys that starts at a multiple of 4 keys.
_MAX_CLUSTER = 8
_KEY_ALIGN = 4
#: K4/K5 cut d into one slice of 16-byte column groups per CTA.
_D_ALIGN = 8 * _MAX_CLUSTER

#: Launches of K3, K4 and K5 (each wrapper adds one per call that launches its kernel).
LN_QKV_COUNTER = kernel_build.KernelCounter("ln_qkv_project")
SELF_ATTEND_COUNTER = kernel_build.KernelCounter("self_attend_and_out")
CROSS_STEP_COUNTER = kernel_build.KernelCounter("cross_attention_step")
COUNTERS = (LN_QKV_COUNTER, SELF_ATTEND_COUNTER, CROSS_STEP_COUNTER)


def ln_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """flax ``nn.LayerNorm`` fast-variance numerics in float32."""
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    mean_sq = (x32 * x32).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return normed * scale.to(torch.float32) + bias.to(torch.float32)


@lru_cache(maxsize=None)
def root_d(head_dim: int, dtype: torch.dtype) -> float:
    """sqrt(Dh) taken in ``dtype`` (the TPU kernels' ``inv_scale``), as a Python float.

    A ``dtype`` tensor divided by this float rounds as a division by the
    ``dtype`` scalar would (the value is exact in ``dtype``), and no tensor is
    copied to the card on each call. The kernels take it for bf16: 8.0 for Dh = 64.
    """
    return float(torch.sqrt(torch.tensor(float(head_dim), dtype=dtype)))


def _attend_reference(q, k_cache, v_cache, bias):
    """Scores over Dh, ``bias`` added (or None), float32 softmax, then P·V.

    q (R, H, Dh); k_cache (R, H, Dh, S); v_cache (R, H, S, Dh). Returns the
    per-head outputs (R, H, Dh) and the float32 weights (R, H, S).
    """
    cdt = q.dtype
    scores = torch.einsum("rhd,rhds->rhs", q, k_cache) / root_d(q.shape[-1], cdt)
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    weights = torch.softmax(scores.to(torch.float32), dim=-1)
    return torch.einsum("rhs,rhsd->rhd", weights.to(cdt), v_cache), weights


def _out_project_reference(heads_out, w_out_heads, b_out, x_residual):
    """Per-head float32 out-projection partials summed in head order (the TPU
    kernels' and K4/K5's order), rounded, + bias, + residual."""
    partials = torch.einsum("rhd,hdc->hrc", heads_out.to(torch.float32), w_out_heads.to(torch.float32))
    acc = partials[0]
    for partial in partials[1:]:
        acc = acc + partial
    y = acc.to(x_residual.dtype) + b_out
    return x_residual + y


def ln_qkv_project_reference(x, ln_scale, ln_bias, w_qkv, b_qkv, *, eps: float) -> torch.Tensor:
    """Plain version of K3: (R, d) → (R, 3d) in ``x``'s dtype."""
    h = ln_f32(x, ln_scale, ln_bias, eps)
    return (torch.matmul(h.to(w_qkv.dtype), w_qkv) + b_qkv).to(x.dtype)


def write_cache_columns(qkv, k_cache, v_cache, position: int) -> torch.Tensor:
    """The decode step's cache update from a (R, 3d) K3 output: K into column
    ``position`` of the (R, H, Dh, S) cache, V into row ``position`` of the
    (R, H, S, Dh) cache, in place. Returns q (R, d)."""
    rows, heads = k_cache.shape[:2]
    d_model = qkv.shape[1] // 3
    k_cache[:, :, :, position] = qkv[:, d_model : 2 * d_model].reshape(rows, heads, -1)
    v_cache[:, :, position, :] = qkv[:, 2 * d_model :].reshape(rows, heads, -1)
    return qkv[:, :d_model]


def ln_qkv_project_to_cache_reference(
    x, ln_scale, ln_bias, w_qkv, b_qkv, k_cache, v_cache, position: int, *, eps: float
) -> torch.Tensor:
    """Plain version of K3's cache form: ``ln_qkv_project_reference``, then the two scatters."""
    qkv = ln_qkv_project_reference(x, ln_scale, ln_bias, w_qkv, b_qkv, eps=eps)
    return write_cache_columns(qkv, k_cache, v_cache, position)


def self_attend_and_out_reference(q_heads, k_cache, v_cache, w_out_heads, b_out, x_residual, position: int):
    """Plain version of K4: (R, H, Dh) queries → (R, d); keys after ``position`` masked."""
    visible = torch.arange(k_cache.shape[-1], device=q_heads.device) <= position
    bias = torch.where(visible, 0.0, _NEG_INF)
    heads_out, _ = _attend_reference(q_heads, k_cache, v_cache, bias)
    return _out_project_reference(heads_out, w_out_heads, b_out, x_residual)


def cross_attention_step_reference(
    x, ln_scale, ln_bias, w_q_heads, b_q_heads, cross_k, cross_v, w_out_heads, b_out, *, eps: float
):
    """Plain version of K5: (R, d) → ((R, d), float32 weights (H, R, S))."""
    cdt = x.dtype
    h = ln_f32(x, ln_scale, ln_bias, eps).to(cdt)
    q = torch.einsum("rd,hde->rhe", h, w_q_heads) + b_q_heads[:, 0]
    heads_out, weights = _attend_reference(q, cross_k, cross_v, None)
    return _out_project_reference(heads_out, w_out_heads, b_out, x), weights.transpose(0, 1)


# --------------------------------------------------------------------------- #
# Wrappers: kernel on a CUDA tensor, plain version on a CPU tensor
# --------------------------------------------------------------------------- #


def require_fused_decode_shapes(d_model: int, heads: int, n_states: int, max_positions: int) -> None:
    """Raises ``ValueError`` naming the first shape rule of K3-K5 that a model breaks.

    The rules the kernels' wrappers check at every step, checked once where a
    model is built for the card: a head dimension of 64, d a multiple of 64
    (K4/K5 cut d into one slice of 16-byte column groups per CTA), and a
    number of encoder states and a cache length that are multiples of 4 (each
    CTA's chunk of keys starts at a multiple of 4 keys). There is no other
    route on the card.
    """
    rules = (  # in this order: the first broken rule is named
        (d_model % _D_ALIGN == 0, f"d % {_D_ALIGN} == 0 (got d = {d_model})"),
        (d_model == heads * _HEAD_DIM, f"a head dimension Dh = d / heads of {_HEAD_DIM} (got {d_model} / {heads})"),
        (n_states % _KEY_ALIGN == 0, f"S % {_KEY_ALIGN} == 0 encoder states (got S = {n_states})"),
        (max_positions % _KEY_ALIGN == 0,
         f"max_target_positions % {_KEY_ALIGN} == 0 (got {max_positions})"),
    )
    for holds, rule in rules:
        if not holds:
            raise ValueError(f"The fused decode (kernels K3-K5) on the card needs {rule}; there is no other route.")


def _require(condition: bool, kernel: str, what: str) -> None:
    if not condition:
        raise ValueError(f"{kernel} takes {what}.")


def _check_cuda_bf16(kernel: str, device: torch.device, *tensors: torch.Tensor) -> None:
    """Raises unless every tensor is a contiguous, 16-byte aligned bf16 tensor on ``device``.

    One combined test per tensor: the decode calls each wrapper 32 times per
    step, so the checks' host time counts.
    """
    for tensor in tensors:
        if tensor.dtype is torch.bfloat16 and tensor.device == device and tensor.is_contiguous():
            if tensor.data_ptr() % 16 == 0:
                continue
        if tensor.dtype is not torch.bfloat16:
            raise TypeError(f"{kernel} takes bfloat16 tensors, got {tensor.dtype}.")
        _require(tensor.device == device, kernel, "all tensors on one CUDA device")
        _require(tensor.is_contiguous(), kernel, "contiguous tensors")
        _require(False, kernel, "16-byte aligned tensors")


def _stream(device: torch.device) -> int:
    """The current stream of ``device`` (looked up by index: the cheapest call)."""
    return torch.cuda.current_stream(device.index).cuda_stream


def chunk_keys(n_keys: int, cluster: int) -> int:
    """Keys per CTA of K4/K5: ``n_keys`` split over ``cluster`` CTAs, rounded up to
    a multiple of 4 (``chunk_keys`` in ``csrc/decode_step.cu``)."""
    return -(-n_keys // (cluster * _KEY_ALIGN)) * _KEY_ALIGN


def chunk_bounds(n_keys: int, cluster: int) -> list[tuple[int, int]]:
    """Each CTA's key range ``[start, stop)``, in rank order; a range may be short or empty."""
    chunk = chunk_keys(n_keys, cluster)
    return [(min(rank * chunk, n_keys), min((rank + 1) * chunk, n_keys)) for rank in range(cluster)]


@lru_cache(maxsize=None)
def _cluster_size(cross: bool, rows: int, heads: int, n_keys: int, d_model: int, device_index: int) -> int:
    """CTAs per head for K4 (``cross`` False) or K5: the largest of 8, 4, 2, 1 whose
    ``heads`` clusters are all resident at once (``cudaOccupancyMaxActiveClusters``),
    else the largest that fits at all. ``n_keys`` is the most keys a call splits."""
    query = kernel_build.load("decode_step_clusters")
    fits = []  # sizes that fit, if not in one wave
    with torch.cuda.device(device_index):
        for cluster in (_MAX_CLUSTER, 4, 2, 1):
            count = ctypes.c_int(0)
            kernel_build.check(
                query(int(cross), cluster, rows, heads, chunk_keys(n_keys, cluster), d_model, ctypes.addressof(count)),
                "decode_step_clusters",
            )
            if count.value >= heads:
                return cluster
            if count.value > 0:
                fits.append(cluster)
    if not fits:
        raise ValueError(f"no cluster of the decode-step kernel fits {rows} rows and {n_keys} keys in shared memory.")
    return fits[0]


_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int) -> torch.Tensor:
    """K4/K5's per-column-slice completion counters for one stream: zero between calls
    (each launch leaves them zero), so calls on one stream share them."""
    key = (device.index, stream)
    counters = _COUNTERS.get(key)
    if counters is None:
        counters = _COUNTERS[key] = torch.zeros(_MAX_CLUSTER, dtype=torch.int32, device=device)
    return counters


def ln_qkv_project(x, ln_scale, ln_bias, w_qkv, b_qkv, *, eps: float) -> torch.Tensor:
    """Fused pre-norm + QKV projection, (R, d) → (R, 3d). Kernel K3 on CUDA tensors.

    Replaces ``ser_tpu/ops/decode_step_kernels.py::ln_qkv_project``. On the
    H100 it is bound by the bytes of ``w_qkv`` (9.8 MB at large-v3, read
    once): a GEMV over 32-column tiles whose block puts its whole weight slice
    in flight (TMA into shared memory) before it computes the LayerNorm, then
    reduces each landed box on the tensor cores (float32 accumulation).
    ``ln_scale``, ``ln_bias`` (1, d); ``w_qkv`` (d, 3d); ``b_qkv`` (1, 3d).
    """
    if x.device.type == "cpu":
        return ln_qkv_project_reference(x, ln_scale, ln_bias, w_qkv, b_qkv, eps=eps)
    out = torch.empty((x.shape[0], w_qkv.shape[1]), dtype=x.dtype, device=x.device)
    _launch_ln_qkv(x, ln_scale, ln_bias, w_qkv, b_qkv, out, None, None, 0, eps)
    return out


def ln_qkv_project_to_cache(
    x, ln_scale, ln_bias, w_qkv, b_qkv, k_cache, v_cache, position: int, *, eps: float
) -> torch.Tensor:
    """K3 writing its own cache columns: returns q (R, d); K and V go in place.

    The same projection as :func:`ln_qkv_project` (same kernel, same bits),
    with the K part written into column ``position`` of ``k_cache`` (R, H, Dh,
    Smax) and the V part into row ``position`` of ``v_cache`` (R, H, Smax, Dh),
    as :func:`write_cache_columns` does; no other cache slot is touched. The
    decode step then needs no scatter of its own. ``position`` is a host int.
    """
    if x.device.type == "cpu":
        return ln_qkv_project_to_cache_reference(
            x, ln_scale, ln_bias, w_qkv, b_qkv, k_cache, v_cache, position, eps=eps
        )
    kernel = "ln_qkv_project"
    rows, d_model = x.shape
    heads = d_model // _HEAD_DIM
    s_max = k_cache.shape[-1]
    _check_cuda_bf16(kernel, x.device, k_cache, v_cache)
    kernel_build.refuse_grad(kernel, k_cache, v_cache)
    _require(w_qkv.shape[1] == 3 * d_model and d_model % _HEAD_DIM == 0, kernel, "w_qkv (d, 3d) with d = 64 H")
    _require(k_cache.shape == (rows, heads, _HEAD_DIM, s_max) and v_cache.shape == (rows, heads, s_max, _HEAD_DIM),
             kernel, "K (R, H, Dh, Smax) and V (R, H, Smax, Dh) caches")
    _require(isinstance(position, int) and 0 <= position < s_max, kernel, "a host int position inside the cache")
    out = torch.empty((rows, d_model), dtype=x.dtype, device=x.device)
    _launch_ln_qkv(x, ln_scale, ln_bias, w_qkv, b_qkv, out, k_cache, v_cache, position, eps)
    return out


def _launch_ln_qkv(x, ln_scale, ln_bias, w_qkv, b_qkv, out, k_cache, v_cache, position: int, eps: float) -> None:
    kernel = "ln_qkv_project"
    rows, d_model = x.shape
    n_out = w_qkv.shape[1]
    _check_cuda_bf16(kernel, x.device, x, ln_scale, ln_bias, w_qkv, b_qkv)
    kernel_build.refuse_grad(kernel, x, ln_scale, ln_bias, w_qkv, b_qkv)
    _require(ln_scale.numel() == d_model and ln_bias.numel() == d_model, kernel, "(1, d) LayerNorm affines")
    _require(w_qkv.shape[0] == d_model and n_out % _TILE_COLS == 0 and d_model % 16 == 0,
             kernel, "w_qkv (d, N) with N % 32 == 0 and d % 16 == 0")
    _require(b_qkv.numel() == n_out, kernel, "b_qkv (1, N)")
    cached = k_cache is not None
    code = kernel_build.load(kernel)(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(),
        out.data_ptr(), k_cache.data_ptr() if cached else None, v_cache.data_ptr() if cached else None,
        rows, d_model, n_out, position, k_cache.shape[-1] if cached else 0, float(eps), _stream(x.device),
    )
    kernel_build.check(code, kernel)
    LN_QKV_COUNTER.launches += 1


def self_attend_and_out(q_heads, k_cache, v_cache, w_out_heads, b_out, x_residual, position: int):
    """Masked cached self-attention + out-projection + residual. Kernel K4 on CUDA.

    Replaces ``ser_tpu/ops/decode_step_kernels.py::self_attend_and_out``.
    ``q_heads`` (R, H, Dh), any row stride; ``k_cache`` (R, H, Dh, Smax);
    ``v_cache`` (R, H, Smax, Dh); ``w_out_heads`` (H, Dh, d); ``b_out`` (1, d);
    ``x_residual`` (R, d); ``position`` a host int: keys 0..position are
    visible. On the H100 it is bound by the bytes of W_out (3.3 MB at
    large-v3) and of the cache up to ``position``, which is all it reads: one
    launch of a cluster per head, the visible keys split over its CTAs.
    """
    if q_heads.device.type == "cpu":
        return self_attend_and_out_reference(q_heads, k_cache, v_cache, w_out_heads, b_out, x_residual, position)
    kernel = "self_attend_and_out"
    rows, heads, head_dim = q_heads.shape
    s_max = k_cache.shape[-1]
    d_model = x_residual.shape[1]
    _check_cuda_bf16(kernel, q_heads.device, k_cache, v_cache, w_out_heads, b_out, x_residual)
    kernel_build.refuse_grad(kernel, q_heads, k_cache, v_cache, w_out_heads, b_out, x_residual)
    if q_heads.dtype != torch.bfloat16 or q_heads.device != x_residual.device:
        raise TypeError(f"{kernel} takes bfloat16 q_heads on the residual's device.")
    _require(head_dim == _HEAD_DIM and q_heads.stride(2) == 1 and q_heads.stride(1) == head_dim,
             kernel, f"q_heads (R, H, {_HEAD_DIM}) with unit stride inside each row")
    _require(q_heads.data_ptr() % 16 == 0 and q_heads.stride(0) % 8 == 0, kernel, "16-byte aligned q rows")
    _require(k_cache.shape == (rows, heads, head_dim, s_max) and v_cache.shape == (rows, heads, s_max, head_dim),
             kernel, "K (R, H, Dh, Smax) and V (R, H, Smax, Dh) caches")
    _require(s_max % _KEY_ALIGN == 0, kernel, f"a cache length that is a multiple of {_KEY_ALIGN}")
    _require(isinstance(position, int) and 0 <= position < s_max, kernel, "a host int position inside the cache")
    _require(w_out_heads.shape == (heads, head_dim, d_model) and d_model % _D_ALIGN == 0,
             kernel, f"w_out_heads (H, Dh, d) with d % {_D_ALIGN} == 0")
    _require(b_out.numel() == d_model and x_residual.shape == (rows, d_model), kernel, "b_out (1, d), x (R, d)")
    cluster = _cluster_size(False, rows, heads, s_max, d_model, q_heads.device.index)
    stream = _stream(q_heads.device)
    partials = torch.empty((heads, rows, d_model), dtype=torch.float32, device=q_heads.device)
    out = torch.empty_like(x_residual)
    code = kernel_build.load(kernel)(
        q_heads.data_ptr(), q_heads.stride(0), k_cache.data_ptr(), v_cache.data_ptr(),
        w_out_heads.data_ptr(), b_out.data_ptr(), x_residual.data_ptr(), partials.data_ptr(),
        _counters(q_heads.device, stream).data_ptr(), out.data_ptr(), rows, heads, s_max, position, d_model,
        cluster, chunk_keys(position + 1, cluster), root_d(head_dim, torch.bfloat16), stream,
    )
    kernel_build.check(code, kernel)
    SELF_ATTEND_COUNTER.launches += 1
    return out


def cross_attention_step(
    x, ln_scale, ln_bias, w_q_heads, b_q_heads, cross_k, cross_v, w_out_heads, b_out, *, eps: float
):
    """The whole cross-attention block. Kernel K5 on CUDA tensors.

    Replaces ``ser_tpu/ops/decode_step_kernels.py::cross_attention_step``.
    ``x`` (R, d); ``w_q_heads`` (H, d, Dh); ``b_q_heads`` (H, 1, Dh);
    ``cross_k`` (R, H, Dh, S); ``cross_v`` (R, H, S, Dh); ``w_out_heads``
    (H, Dh, d); ``b_out`` (1, d). Returns (x' (R, d), float32 weights
    (H, R, S)); alignment capture indexes ``weights[head]``. On the H100 it is
    bound by the bytes of W_q, W_out (6.6 MB) and the encoder K/V (3.8 MB per
    row at large-v3): one launch of a cluster per head, S split over its CTAs.
    """
    if x.device.type == "cpu":
        return cross_attention_step_reference(
            x, ln_scale, ln_bias, w_q_heads, b_q_heads, cross_k, cross_v, w_out_heads, b_out, eps=eps
        )
    kernel = "cross_attention_step"
    rows, d_model = x.shape
    heads, _, head_dim = w_q_heads.shape
    s_len = cross_k.shape[-1]
    _check_cuda_bf16(kernel, x.device, x, ln_scale, ln_bias, w_q_heads, b_q_heads, cross_k, cross_v,
                     w_out_heads, b_out)
    kernel_build.refuse_grad(kernel, x, ln_scale, ln_bias, w_q_heads, b_q_heads, cross_k, cross_v, w_out_heads,
                             b_out)
    _require(head_dim == _HEAD_DIM and w_q_heads.shape == (heads, d_model, head_dim),
             kernel, f"w_q_heads (H, d, {_HEAD_DIM})")
    _require(b_q_heads.numel() == heads * head_dim, kernel, "b_q_heads (H, 1, Dh)")
    _require(cross_k.shape == (rows, heads, head_dim, s_len) and cross_v.shape == (rows, heads, s_len, head_dim),
             kernel, "K (R, H, Dh, S) and V (R, H, S, Dh)")
    _require(s_len % _KEY_ALIGN == 0, kernel, f"a number of encoder states that is a multiple of {_KEY_ALIGN}")
    _require(w_out_heads.shape == (heads, head_dim, d_model) and d_model % _D_ALIGN == 0,
             kernel, f"w_out_heads (H, Dh, d) with d % {_D_ALIGN} == 0")
    _require(ln_scale.numel() == d_model and ln_bias.numel() == d_model and b_out.numel() == d_model,
             kernel, "(1, d) LayerNorm affines and b_out")
    cluster = _cluster_size(True, rows, heads, s_len, d_model, x.device.index)
    stream = _stream(x.device)
    partials = torch.empty((heads, rows, d_model), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    weights = torch.empty((heads, rows, s_len), dtype=torch.float32, device=x.device)
    code = kernel_build.load(kernel)(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w_q_heads.data_ptr(), b_q_heads.data_ptr(),
        cross_k.data_ptr(), cross_v.data_ptr(), w_out_heads.data_ptr(), b_out.data_ptr(),
        partials.data_ptr(), _counters(x.device, stream).data_ptr(), out.data_ptr(), weights.data_ptr(),
        rows, heads, s_len, d_model, cluster, chunk_keys(s_len, cluster), float(eps),
        root_d(head_dim, torch.bfloat16), stream,
    )
    kernel_build.check(code, kernel)
    CROSS_STEP_COUNTER.launches += 1
    return out, weights


# --------------------------------------------------------------------------- #
# Weight re-layouts (once per model, not per step)
# --------------------------------------------------------------------------- #


def per_head_out_proj(w_out: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``(d, d)`` output projection (in, out) → ``(H, Dh, d)`` per-head blocks (a view)."""
    d_in, d_out = w_out.shape
    return w_out.reshape(n_heads, d_in // n_heads, d_out)


def per_head_q_proj(w_q: torch.Tensor, b_q: torch.Tensor, n_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(d, d)`` Q projection (in, out) → ``(H, d, Dh)`` blocks + ``(H, 1, Dh)`` bias."""
    d_in, d_out = w_q.shape
    head_dim = d_out // n_heads
    w = w_q.reshape(d_in, n_heads, head_dim).permute(1, 0, 2).contiguous()
    return w, b_q.reshape(n_heads, 1, head_dim)


__all__ = [
    "COUNTERS",
    "CROSS_STEP_COUNTER",
    "LN_QKV_COUNTER",
    "SELF_ATTEND_COUNTER",
    "chunk_bounds",
    "chunk_keys",
    "cross_attention_step",
    "cross_attention_step_reference",
    "ln_qkv_project",
    "ln_qkv_project_reference",
    "ln_qkv_project_to_cache",
    "ln_qkv_project_to_cache_reference",
    "per_head_out_proj",
    "per_head_q_proj",
    "require_fused_decode_shapes",
    "self_attend_and_out",
    "self_attend_and_out_reference",
    "write_cache_columns",
]
