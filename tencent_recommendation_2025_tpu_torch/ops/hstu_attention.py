"""Standalone HSTU pointwise attention: CUDA kernels, plain versions, autograd.

Counterpart of ``tencent_recommendation_2025_tpu/ops/hstu_attention.py``.
Per batch row and head, on head-packed [B, L, D] post-SiLU q, k, v (D = H *
hd) and a rel-pos bias ``rab`` [H, buckets]:

    s   = T(q * hd^-1/2) k^T + rab[h, clip(q - k, 0, buckets - 1)]   (f32)
    a   = T(silu(s) * causal * key_valid / seq_len)
    out = a @ v                                   (f32 sums, out in T)

with T the compute dtype (bf16 on the card's product path, f32 in the
checks) and ``seq_len`` the padded length. The backward gives dq, dk, dv in
T and ``drab`` [H, buckets] in f32, summed over the batch.

Kernels (``csrc/hstu_attention.cu``), two designs chosen in one place on
the C side (``hstu_wgmma_route``):

- bf16 with hd % 8 == 0 and hd <= 128 (every HSTU preset): Hopper wgmma
  kernels on the loops the fused block and the ring already run.
  ``hstu_fwd_wgmma_kernel`` replaces ``_fwd_kernel`` (l.164) and
  ``_fwd_kernel_chunk`` (l.297) on the attention step of
  ``csrc/fused_block_sm90.cuh``; ``attn_bwd_dq_wgmma_kernel``,
  ``attn_bwd_dkdv_wgmma_kernel`` (``csrc/hstu_attn_bwd_sm90.cuh``, their
  standalone instance) and ``reduce_rows_split_kernel`` replace
  ``_bwd_kernel`` (l.193), ``_dq_kernel_chunk`` (l.331) and
  ``_dkdv_kernel_chunk`` (l.380). They keep the rounding points above
  inside the kernels: q rounds to T(q * hd^-1/2) in shared memory, a and
  ds take 1/L before they round, the outputs are stored in T.
- f32 (the tight check instance) and every other head (hd past 128): the
  first design, ``hstu_fwd_kernel``, ``hstu_bwd_dq_kernel``,
  ``hstu_bwd_dkdv_kernel`` and ``reduce_rows_kernel``, which takes any hd:
  past the width where a 16-row tile set of the whole head fits shared
  memory it streams the head through in column slices.

The TPU kernels read the bias from
precomputed [blk, blk] tiles and return tile gradients; the CUDA kernels
read ``rab`` by distance and sum its gradient straight into its buckets
(the same values: every distance of a far tile clamps to the last bucket).
The TPU takes its chunked kernels past ``_use_long`` (L * max(D, 64) > 1024
* 64), where a whole [L, D] row no longer fits its VMEM; the CUDA kernels
stream key tiles through shared memory at any L, so one kernel design
serves both routes, which count their launches apart:
``hstu_attention_fwd.launches`` / ``hstu_attention_bwd.launches`` for the
whole-sequence shapes, ``hstu_attention_chunk_fwd.launches`` /
``hstu_attention_chunk_bwd.launches`` for the chunked ones. Bound at
hstu_mini's shapes on the H100: bytes at B=64, L=256 (2.5 us forward, 4.4
us backward); operations at B=32, L=4096 (0.069 ms, 0.174 ms).

The bucket limit follows the bias-tile block the JAX package picks
(``_tile_blk``): 128 on the whole-sequence route (at most 898 buckets),
256 on the chunked one where L and its VMEM budget allow (at most 1794).
The encoder takes these kernels where the JAX package's
``make_attention_cores`` does: an HSTU block that the fused gate refuses,
at 256 <= L, L % 128 == 0.

``silu_qkv=True`` (the JAX package's flag, every kernel body) takes the
PRE-activation q, k, v: each kernel applies the SiLU in f32 as its q, k
and v tiles land (q to T(silu(q) * hd^-1/2), one rounding; k and v to
T(silu(.)); JAX ``_load_qkv``, l.143), and the backward's epilogues
multiply dq, dk and dv by dsilu of the output rows' pre-activations, read
from global memory (l.250-261, 375, 424). No route of the port or of the
JAX package sets it (``models/hstu.py``'s ``fused_silu`` hook); its
launches count apart, in each wrapper's ``silu_launches``.

Each wrapper takes its plain version for tensors on the CPU and launches its
kernel for CUDA tensors; it never falls back: a launch the chosen design
cannot make raises. The kernels take any head dim (the first design: WMMA
tensor-core products where hd % 16 == 0 in bf16, FMA loops otherwise) and
L a multiple of 64, bf16 or f32; anything else raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as Fn

from . import kernels
from .fused_block import _dsilu, _heads, _mm, _rab_grad, _rows, _stream

BLK = 128
MAX_WHOLESEQ_L = 1024
#: L is a multiple of the kernels' largest query and key tile
KERNEL_TILE = 64


def _n_near(buckets: int, blk: int = BLK) -> int:
    """Number of sub-diagonal block slots whose bias tile is non-constant in
    the TPU kernels. Capped at 8 slots; configs needing more (buckets >
    7*blk + 2) fail loudly here, as they do in the JAX package."""
    needed = (buckets - 2 + blk - 1) // blk + 1
    if needed > 8:
        raise ValueError(
            f"hstu_rel_pos_buckets={buckets} needs {needed} non-constant "
            f"bias tile slots but the kernel supports at most 8 "
            f"(buckets <= {7 * blk + 2}); use fewer buckets or the dense "
            f"XLA path")
    return needed


def _chunk_blk(L: int, H: int, buckets: int) -> int:
    """The JAX package's bias-tile block of its chunked kernels: 256 when it
    divides L and the [H, nt, blk, blk] f32 tile stack and its gradient fit
    8 MiB of VMEM, else 128 (``_n_near`` raises where the buckets need
    more than 8 slots at the block it tries)."""
    for blk in (256, 128):
        if L % blk != 0:
            continue
        nt = _n_near(buckets, blk) + 1
        if 2 * H * nt * blk * blk * 4 <= 8 * 1024 * 1024:
            return blk
    return BLK


def _use_long(L: int, D: int) -> bool:
    """Whole-sequence vs chunked-KV dispatch of the JAX package (D-aware;
    read ``MAX_WHOLESEQ_L`` at call time, so a test can shrink it)."""
    return L * max(D, 64) > MAX_WHOLESEQ_L * 64


def _tile_blk(L: int, H: int, buckets: int, D: int = 64) -> int:
    """The JAX package's bias-tile block: ``BLK`` on the whole-sequence
    route, ``_chunk_blk`` on the chunked one."""
    return _chunk_blk(L, H, buckets) if _use_long(L, D) else BLK


def check_attention_inputs(name: str, num_heads: int, q: torch.Tensor,
                           *others: torch.Tensor,
                           max_head_dim: Optional[int] = None) -> None:
    """Raise on what an attention kernel does not take: q and every other
    [B, L, D] operand alike in shape and dtype (bf16 or f32), L a multiple
    of 64, D a multiple of num_heads, contiguous, 16-byte aligned, on one
    device; a head dim past the kernel's ``max_head_dim`` (None: any, the
    HSTU kernels) raises ``NotImplementedError``."""
    B, L, D = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} takes bf16 or f32, not {q.dtype}")
    if D % num_heads:
        raise ValueError(f"{name} needs D % H == 0 (D={D}, H={num_heads})")
    if max_head_dim is not None and D // num_heads > max_head_dim:
        raise NotImplementedError(
            f"{name}: head dim {D // num_heads} (D={D}, H={num_heads}) is "
            f"past the {max_head_dim} the kernel takes: no route of the "
            "port or of the JAX package reaches it (ROADMAP Queue 3, heads "
            "wider than 256)")
    if L % KERNEL_TILE:
        raise ValueError(f"{name} needs L % {KERNEL_TILE} == 0 (L={L})")
    for t in (q, *others):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name}: q, k, v (and dout) must match in shape "
                             f"and dtype")
        if t.device != q.device:
            raise ValueError(f"{name}: operands on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and "
                             f"16-byte aligned")


def valid_int32(valid: torch.Tensor, shape) -> torch.Tensor:
    """The [B, L] key-valid mask as the kernels read it (int32, nonzero =
    valid key)."""
    if tuple(valid.shape) != tuple(shape[:2]):
        raise ValueError(f"valid has shape {tuple(valid.shape)}, expected "
                         f"{tuple(shape[:2])}")
    return valid.to(torch.int32).contiguous()


def causal_valid(valid: torch.Tensor, L: int) -> torch.Tensor:
    """[B, 1, L, L] bool: causal (key <= query) and key valid."""
    pos = torch.arange(L, device=valid.device)
    return (pos[None, :] <= pos[:, None])[None, None] \
        & (valid != 0)[:, None, None, :]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _act(q, k, v, num_heads, silu_qkv):
    """The operands the products take: (qs = T(act(q) * hd^-1/2), T(act(k)),
    T(act(v))), act the SiLU in f32 with ``silu_qkv`` (q, k, v then the
    pre-activations) and the identity without it (k and v as they are),
    each rounded once."""
    hd = q.shape[2] // num_heads
    if not silu_qkv:
        return (q.float() * hd ** -0.5).to(q.dtype), k, v
    return ((Fn.silu(q.float()) * hd ** -0.5).to(q.dtype),
            Fn.silu(k.float()).to(k.dtype), Fn.silu(v.float()).to(v.dtype))


def _scores(qs, k, valid, rab, num_heads):
    """(qs in heads, s with the bias [B, H, L, L] f32, mask) of the
    operands :func:`_act` gives."""
    L = qs.shape[1]
    qh = _heads(qs, num_heads)
    pos = torch.arange(L, device=qs.device)
    bucket = (pos[:, None] - pos[None, :]).clamp(0, rab.shape[1] - 1)
    s = _mm(qh, _heads(k, num_heads).transpose(-1, -2)) \
        + rab.float()[:, bucket][None]
    return qh, s, causal_valid(valid, L)


def hstu_attention_fwd_plain(q, k, v, valid, rab, seq_len: int,
                             num_heads: int,
                             silu_qkv: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel, with its rounding
    points (``silu_qkv``: q, k, v are pre-activations, :func:`_act`)."""
    qs, k, v = _act(q, k, v, num_heads, silu_qkv)
    _, s, mask = _scores(qs, k, valid, rab, num_heads)
    a = (Fn.silu(s) * (mask.float() / seq_len)).to(q.dtype)
    return _rows(_mm(a, _heads(v, num_heads))).to(q.dtype)


def hstu_attention_bwd_plain(q, k, v, dout, valid, rab, seq_len: int,
                             num_heads: int, silu_qkv: bool = False
                             ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward kernel, written out op by op with its
    rounding points: (dq, dk, dv) in the compute dtype, drab [H, buckets]
    in f32. With ``silu_qkv`` the gradients are the pre-activations':
    dq = T(dq_acc hd^-1/2 dsilu(q)), dk = T(dk_acc dsilu(k)), dv =
    T(dv_acc dsilu(v)), dsilu in f32 of the inputs, dk_acc summed against
    the rounded T(silu(q) hd^-1/2)."""
    cdt = q.dtype
    hd = q.shape[2] // num_heads
    qs, ka, va = _act(q, k, v, num_heads, silu_qkv)
    qh, s, mask = _scores(qs, ka, valid, rab, num_heads)
    m = mask.float() / seq_len
    a = (Fn.silu(s) * m).to(cdt)
    do = _heads(dout.to(cdt), num_heads)
    dv = _rows(_mm(a.transpose(-1, -2), do))
    ds = _mm(do, _heads(va, num_heads).transpose(-1, -2)) * _dsilu(s) * m
    dsc = ds.to(cdt)
    dq = _rows(_mm(dsc, _heads(ka, num_heads))) * hd ** -0.5
    dk = _rows(_mm(dsc.transpose(-1, -2), qh))
    if silu_qkv:
        dq = dq * _dsilu(q.float())
        dk = dk * _dsilu(k.float())
        dv = dv * _dsilu(v.float())
    return (dq.to(cdt), dk.to(cdt), dv.to(cdt),
            _rab_grad(ds.sum(0), rab.shape[1]))


def hstu_attention_oracle(q, k, v, valid, rab, seq_len: int) -> torch.Tensor:
    """Dense reference over [B, H, L, hd] for tests (the JAX package's
    oracle: f32 throughout, q scaled after the product)."""
    B, H, L, hd = q.shape
    pos = torch.arange(L, device=q.device)
    bucket = (pos[:, None] - pos[None, :]).clamp(0, rab.shape[1] - 1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5 \
        + rab.float()[:, bucket][None]
    a = Fn.silu(s) * causal_valid(valid, L).float() / seq_len
    return torch.matmul(a, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _fn(name: str, n_ptr: int):
    fn = getattr(kernels.load("hstu_attention"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [_I, _I] + [_P] * n_ptr + [_I] * 5 + [_F, _F, _P]
    return fn


def _check_rab(rab: torch.Tensor, num_heads: int, device) -> torch.Tensor:
    if rab.dim() != 2 or rab.shape[0] != num_heads:
        raise ValueError(f"rab must be [{num_heads}, buckets], not "
                         f"{tuple(rab.shape)}")
    if rab.device != device:
        raise ValueError("rab is on another device than q")
    return rab.to(torch.float32).contiguous()


def _launch_fwd(q, k, v, valid, rab, seq_len, num_heads, silu_qkv):
    check_attention_inputs("hstu attention kernel", num_heads, q, k, v)
    B, L, D = q.shape
    vi = valid_int32(valid, q.shape)
    rab = _check_rab(rab, num_heads, q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _fn("hstu_attn_fwd", 6)(
            int(q.dtype == torch.bfloat16), int(silu_qkv), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), vi.data_ptr(), rab.data_ptr(),
            out.data_ptr(), B, L, D, num_heads, rab.shape[1],
            float(D // num_heads) ** -0.5, 1.0 / seq_len, _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"hstu_attn_fwd kernel launch failed: CUDA error "
                           f"{rc}")
    return out


def _launch_bwd(q, k, v, dout, valid, rab, seq_len, num_heads, silu_qkv):
    check_attention_inputs("hstu attention backward", num_heads, q, k, v,
                           dout)
    B, L, D = q.shape
    vi = valid_int32(valid, q.shape)
    rab = _check_rab(rab, num_heads, q.device)
    NB = rab.shape[1]
    is_bf16 = int(q.dtype == torch.bfloat16)
    tile_fn = kernels.load("hstu_attention").hstu_attn_bwd_tile
    tile_fn.restype = _I
    tile_fn.argtypes = [_I] * 4
    # query rows per rel-pos partial: 64 on the wgmma route
    tile = tile_fn(is_bf16, D, num_heads, NB)
    if tile == 0:
        raise ValueError(f"hstu attention backward: no tile fits shared "
                         f"memory at hd={D // num_heads}, {NB} buckets")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # the rel-pos gradient of each (batch row, tile), summed in order
    part = torch.empty((B * (L // tile), num_heads, NB), dtype=torch.float32,
                       device=q.device)
    drab = torch.empty((num_heads, NB), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _fn("hstu_attn_bwd", 11)(
            is_bf16, int(silu_qkv), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), vi.data_ptr(), rab.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), part.data_ptr(),
            drab.data_ptr(), B, L, D, num_heads, NB,
            float(D // num_heads) ** -0.5, 1.0 / seq_len, _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"hstu_attn_bwd kernel launch failed: CUDA error "
                           f"{rc}")
    return dq, dk, dv, drab


def _on_card(name: str, q: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version); True for CUDA ones;
    raises for any other device."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {q.device}")
    return True


def _count(wrapper, silu_qkv: bool) -> None:
    """One launch on ``wrapper``'s counter: ``launches``, or for the
    ``silu_qkv`` instances ``silu_launches``."""
    if silu_qkv:
        wrapper.silu_launches += 1
    else:
        wrapper.launches += 1


def hstu_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       valid: torch.Tensor, rab: torch.Tensor, seq_len: int,
                       num_heads: int, silu_qkv: bool = False
                       ) -> torch.Tensor:
    """The forward kernel on head-packed [B, L, D] q, k, v (pre-activations
    with ``silu_qkv``); ``valid`` [B, L] (nonzero = valid key), ``rab``
    [H, buckets]. CPU tensors take the plain version; CUDA tensors launch
    the kernel, counted in ``hstu_attention_fwd.launches`` (``silu_qkv``:
    ``.silu_launches``), or for a chunked shape (``_use_long``) in
    :func:`hstu_attention_chunk_fwd`'s count."""
    if not _on_card("hstu_attention_fwd", q):
        return hstu_attention_fwd_plain(q, k, v, valid, rab, seq_len,
                                        num_heads, silu_qkv)
    if _use_long(q.shape[1], q.shape[2]):
        return hstu_attention_chunk_fwd(q, k, v, valid, rab, seq_len,
                                        num_heads, silu_qkv)
    out = _launch_fwd(q, k, v, valid, rab, seq_len, num_heads, silu_qkv)
    _count(hstu_attention_fwd, silu_qkv)
    return out


def hstu_attention_chunk_fwd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, valid: torch.Tensor,
                             rab: torch.Tensor, seq_len: int,
                             num_heads: int, silu_qkv: bool = False
                             ) -> torch.Tensor:
    """The forward kernel where the JAX package takes ``_fwd_kernel_chunk``
    (counted in ``hstu_attention_chunk_fwd.launches``, ``silu_qkv``:
    ``.silu_launches``)."""
    if not _on_card("hstu_attention_chunk_fwd", q):
        return hstu_attention_fwd_plain(q, k, v, valid, rab, seq_len,
                                        num_heads, silu_qkv)
    out = _launch_fwd(q, k, v, valid, rab, seq_len, num_heads, silu_qkv)
    _count(hstu_attention_chunk_fwd, silu_qkv)
    return out


def hstu_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, valid: torch.Tensor,
                       rab: torch.Tensor, seq_len: int, num_heads: int,
                       silu_qkv: bool = False) -> Tuple[torch.Tensor, ...]:
    """The backward kernels: (dq, dk, dv, drab), with ``silu_qkv`` the
    pre-activations' dq, dk, dv. CPU tensors take the plain version; CUDA
    tensors launch the kernels, one count in ``hstu_attention_bwd.launches``
    (``silu_qkv``: ``.silu_launches``), or for a chunked shape in
    :func:`hstu_attention_chunk_bwd`'s."""
    if not _on_card("hstu_attention_bwd", q):
        return hstu_attention_bwd_plain(q, k, v, dout, valid, rab, seq_len,
                                        num_heads, silu_qkv)
    if _use_long(q.shape[1], q.shape[2]):
        return hstu_attention_chunk_bwd(q, k, v, dout, valid, rab, seq_len,
                                        num_heads, silu_qkv)
    grads = _launch_bwd(q, k, v, dout, valid, rab, seq_len, num_heads,
                        silu_qkv)
    _count(hstu_attention_bwd, silu_qkv)
    return grads


def hstu_attention_chunk_bwd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, dout: torch.Tensor,
                             valid: torch.Tensor, rab: torch.Tensor,
                             seq_len: int, num_heads: int,
                             silu_qkv: bool = False
                             ) -> Tuple[torch.Tensor, ...]:
    """The backward kernels where the JAX package takes
    ``_dq_kernel_chunk`` and ``_dkdv_kernel_chunk`` (one count in
    ``hstu_attention_chunk_bwd.launches``, ``silu_qkv``:
    ``.silu_launches``)."""
    if not _on_card("hstu_attention_chunk_bwd", q):
        return hstu_attention_bwd_plain(q, k, v, dout, valid, rab, seq_len,
                                        num_heads, silu_qkv)
    grads = _launch_bwd(q, k, v, dout, valid, rab, seq_len, num_heads,
                        silu_qkv)
    _count(hstu_attention_chunk_bwd, silu_qkv)
    return grads


for _w in (hstu_attention_fwd, hstu_attention_chunk_fwd, hstu_attention_bwd,
           hstu_attention_chunk_bwd):
    _w.launches = 0
    _w.silu_launches = 0


class HstuAttentionFn(torch.autograd.Function):
    """``apply(q, k, v, valid, rab, seq_len, num_heads, silu_qkv)``: the
    forward kernel, and the backward kernel for dq, dk, dv and the f32
    ``rab`` gradient."""

    @staticmethod
    def forward(ctx, q, k, v, valid, rab, seq_len, num_heads, silu_qkv):
        ctx.save_for_backward(q, k, v, valid, rab)
        ctx.seq_len, ctx.num_heads, ctx.silu_qkv = seq_len, num_heads, \
            silu_qkv
        return hstu_attention_fwd(q, k, v, valid, rab, seq_len, num_heads,
                                  silu_qkv)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, valid, rab = ctx.saved_tensors
        dq, dk, dv, drab = hstu_attention_bwd(
            q, k, v, dout.contiguous(), valid, rab, ctx.seq_len,
            ctx.num_heads, ctx.silu_qkv)
        return dq, dk, dv, None, drab.to(rab.dtype), None, None, None


def hstu_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid: torch.Tensor, rab: torch.Tensor,
                          seq_len: int, num_heads: int,
                          silu_qkv: bool = False) -> torch.Tensor:
    """Head-packed HSTU attention: q/k/v [B, L, D] (D = H * hd), valid
    [B, L], rab [H, buckets]. Returns [B, L, D]. Differentiable in q, k, v
    and rab. ``silu_qkv``: q, k, v are the PRE-activation projections and
    the SiLU runs inside the kernels, their gradients through dsilu in the
    epilogues (the JAX package's flag). Raises the JAX package's
    ``ValueError`` where its bias tiles at the block its dispatch picks
    (``_tile_blk``) take fewer buckets."""
    L, D = q.shape[1], q.shape[2]
    _n_near(rab.shape[1], _tile_blk(L, rab.shape[0], rab.shape[1], D))
    return HstuAttentionFn.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), valid, rab, seq_len,
                                 num_heads, silu_qkv)


def hstu_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid: torch.Tensor, rab: torch.Tensor,
                   seq_len: int, silu_qkv: bool = False) -> torch.Tensor:
    """[B, H, L, hd] interface (transposes into the packed layout)."""
    B, H, L, hd = q.shape

    def pack(t):
        return t.transpose(1, 2).reshape(B, L, H * hd).contiguous()

    out = hstu_attention_packed(pack(q), pack(k), pack(v), valid, rab,
                                seq_len, H, silu_qkv)
    return out.reshape(B, L, H, hd).transpose(1, 2)
