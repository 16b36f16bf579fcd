"""Distributional-Graphormer score network (DiG) as PyTorch modules.

Counterpart of ``se3diff_tpu/models/dig.py`` (reference
`bioemu/src/bioemu/models.py` and `bioemu/src/bioemu/structure_module.py`) on
dense ``[B, L, ...]`` batches. Module names follow the reference, so a
reference state dict (``model_nn.x1d_proj.0.weight``,
``model_nn.st_module.encoder.layers.{i}.attn.point_query.weight``, ...)
loads with ``load_state_dict(strict=True)``.

* ``SAAttention`` is DiG's IPA (structure_module.py:56-220): scalar qkv,
  4 query/key points, 8 value points, pair bias, learned per-head point
  weight ``softplus(gamma)``, a ``pair_value`` projection, and point logits
  that sum Euclidean norms over points. Its attention core always runs
  through :func:`se3diff_torch.ops.ipa_attention.sp_ipa_attention` (the
  kernel on a slab of query rows, all of them without SP), in the kernel
  layout, with the per-layer pair bias ``pa`` streamed from the
  conditioning cache, or, for a cache built ``with_pa=False`` (the PPFT
  control net, as the JAX package's unfused path), computed inside the
  kernel from ``x2d`` and the layer's ``pair_bias`` weight.
* The pair-value projection is the kernel's fused finalize: its weight
  loads as ``pair_value.weight`` (a :class:`HeadwiseLinear`) and reaches the
  kernel as ``w_pv [H, Cp, dk]``.
* Parameters stay float32. With ``dtype=torch.bfloat16`` the projections,
  residual stream and pair stack run in bf16; layer norms compute their
  statistics in f32; point aggregation and the score heads stay f32.
* The translation score is made equivariant via ``IR_perturbed^T @ T_eps``
  (models.py:305) and the wrapper feeds inverse rotations and ``t * 1000``
  (models.py:359-384).
* Sequence parallelism (SP), the counterpart of the JAX model's
  ``pair_sharding``: a model built with ``sp`` (a
  :class:`~se3diff_torch.parallel.mesh.RankContext`) holds only its rank's
  row slab ``r0:r1`` of the ``[B, L, L, ·]`` pair tensors (``x2d`` and every
  layer's ``pa``). Each layer computes queries, attention, ``fc_out`` and
  the FFN for the slab's rows only, keys and values for all rows, and
  rebuilds the full residual stream with one
  :func:`~se3diff_torch.parallel.mesh.gather_rows`. ``x1d``, the column
  bias and the diff head stay full. Without ``sp`` the model computes what
  it always did.
* Tensor parallelism (TP), the counterpart of the JAX package's DP+TP train
  step: a model built with ``tp`` (a
  :class:`~se3diff_torch.parallel.mesh.MeshContext` with ``model = M > 1``)
  holds its model rank's shard of the parameters
  (``parallel/sharding.py``): each ``SAAttention`` ``H/M`` heads, so the
  conditioning cache's ``pa`` is ``[n_layer, B, H/M, L, L]`` and K1 runs on
  the rank's heads; each ``FeedForward`` ``dim_feedforward/M`` hidden units.
  Each head-split region starts with
  :func:`~se3diff_torch.parallel.mesh.copy_in` on its replicated inputs
  and ends in a linear over split input features whose partial products one
  :func:`~se3diff_torch.parallel.mesh.reduce_out` sums before the bias is
  added. The replicated ``x2d`` feeds only head-split work, so its gradient
  is a partial sum on each rank; rather than sum that ``[B, L, L, Cp]``
  gradient, ``embed_conditioning`` passes the parameters of ``x2d_proj``
  and ``rp_proj`` through one ``copy_in`` where it uses them, which sums
  their few-KB gradients in one collective. Without ``tp`` the model
  computes what it always did.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from se3diff_torch.ops.ipa_attention import NEG_INF, sp_ipa_attention
from se3diff_torch.parallel.mesh import MeshContext, RankContext, copy_in, gather_rows, reduce_out

# Evoformer embedding dims (models.py:15-16).
EVOFORMER_NODE_DIM = 384
EVOFORMER_EDGE_DIM = 128


def _linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``lin`` applied in ``dtype`` (input and weights cast, f32 parameters kept)."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def _split_in_linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype,
                     tp: MeshContext | None) -> torch.Tensor:
    """``lin`` in ``dtype`` on input features split over ``tp``'s model group:
    the rank's partial product summed over the group in f32, then the whole
    bias added once. Plain :func:`_linear` without ``tp``."""
    if tp is None:
        return _linear(x, lin, dtype)
    partial = F.linear(x.to(dtype), lin.weight.to(dtype)).float()
    return (reduce_out(partial, tp) + lin.bias).to(dtype)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """Layer norm with f32 statistics, output in ``dtype``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(dtype)


class SinusoidalPositionEmbedder(nn.Module):
    """DiG sinusoidal time embedding; input rescaled to [0, 1000] (models.py:19-69)."""

    def __init__(self, dim: int, max_period: int = 10_000, min_input: float = 0.0,
                 max_input: float = 1000.0):
        super().__init__()
        self.dim, self.max_period = dim, max_period
        self.min_input, self.max_input = min_input, max_input
        # The reference's fp16-detection sentinel; kept so state dicts match.
        self.register_buffer("dummy", torch.empty(0))

    def forward(self, time: torch.Tensor) -> torch.Tensor:
        half_dim = self.dim // 2
        factor = -math.log(self.max_period) / (half_dim - 1)
        time = (time - self.min_input) * 1000.0 / (self.max_input - self.min_input)
        freqs = torch.exp(
            torch.arange(half_dim, dtype=torch.float32, device=time.device) * factor
        )
        args = time[:, None].float() * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def relative_position_bucket(
    relative_position: torch.Tensor, num_buckets: int, max_distance: int
) -> torch.Tensor:
    """DiG bucketing of relative sequence offsets (models.py:95-126)."""
    num_buckets //= 2
    ret = (relative_position < 0).to(torch.int32) * num_buckets
    rp = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = rp < max_exact
    rp_safe = rp.clamp(min=1)
    val_if_large = max_exact + (
        torch.log(rp_safe.float() / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, rp.to(torch.int32), val_if_large)


class RelativePositionBias(nn.Module):
    """Learnable embedding of bucketed relative positions (models.py:72-145)."""

    def __init__(self, num_buckets: int = 64, max_distance: int = 256, out_dim: int = 2):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, out_dim)

    def forward(self, relative_position: torch.Tensor,
                weight: torch.Tensor | None = None) -> torch.Tensor:
        """The embedding of ``relative_position``'s buckets, from ``weight``
        when given (the table as the caller passes it on), else the module's."""
        bucket = relative_position_bucket(relative_position, self.num_buckets, self.max_distance)
        # A one-hot product, not an index lookup: the same values exactly,
        # but its weight gradient is a matmul, where the embedding's CUDA
        # backward adds rows with atomics in no fixed order (exact resume of
        # training needs every step to be bit-reproducible).
        if weight is None:
            weight = self.relative_attention_bias.weight
        return F.one_hot(bucket.long(), self.num_buckets).to(weight.dtype) @ weight


class FeedForward(nn.Module):
    """Linear -> GELU -> Dropout -> Linear -> Dropout (structure_module.py:12-26).
    Under ``tp``, the rank's ``dim_feedforward / M`` hidden units."""

    def __init__(self, d_model: int, dim_feedforward: int, dropout: float,
                 dtype: torch.dtype = torch.float32, tp: MeshContext | None = None):
        super().__init__()
        self.dtype, self.tp = dtype, tp
        hidden = dim_feedforward // (1 if tp is None else tp.model)
        self.ff = nn.Sequential(
            nn.Linear(d_model, hidden), nn.GELU(), nn.Dropout(dropout),
            nn.Linear(hidden, d_model), nn.Dropout(dropout),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ff[2](F.gelu(_linear(copy_in(x, self.tp), self.ff[0], self.dtype)))
        return self.ff[4](_split_in_linear(x, self.ff[3], self.dtype, self.tp))


class DiffHead(nn.Module):
    """Two [LN, Linear, ReLU, Linear] heads -> (T_eps, IR_eps) in f32
    (structure_module.py:29-53)."""

    def __init__(self, ninp: int):
        super().__init__()

        def head():
            return nn.Sequential(
                nn.LayerNorm(ninp), nn.Linear(ninp, ninp), nn.ReLU(), nn.Linear(ninp, 3)
            )

        self.fc_t = head()
        self.fc_eps = head()

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = x.float()
        return self.fc_t(x), self.fc_eps(x)


class HeadwiseLinear(nn.Linear):
    """Per-head slice of a no-bias Linear: input ``[..., H, Cin]`` -> output
    ``[..., H, out_features/H]``, head h using weight rows
    ``[h*dk : (h+1)*dk]``. State-dict compatible with ``nn.Linear`` (the
    reference's ``pair_value``)."""

    def __init__(self, in_features: int, out_features: int, n_head: int):
        super().__init__(in_features, out_features, bias=False)
        self.n_head = n_head

    def head_major_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The weight as ``[H, Cin, dk]``, contiguous, in ``dtype``."""
        w = self.weight.to(dtype).reshape(self.n_head, -1, self.in_features)
        return w.transpose(1, 2).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("...hp,hpc->...hc", x, self.head_major_weight(x.dtype))


class SAAttention(nn.Module):
    """DiG invariant point attention (structure_module.py:56-220). Under
    ``tp``, the rank's ``n_head / M`` heads (``self.n_head``)."""

    def __init__(self, d_model: int, d_pair: int, n_head: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32, tp: MeshContext | None = None):
        super().__init__()
        if d_model % n_head != 0:
            raise ValueError("d_model must be a multiple of n_head")
        M = 1 if tp is None else tp.model
        if n_head % M != 0:
            raise ValueError(f"{n_head} heads do not split over {M} model ranks")
        H, dk = n_head // M, d_model // n_head
        self.d_model, self.d_pair, self.dtype, self.tp = d_model, d_pair, dtype, tp
        self.n_head, self.head_dim = H, dk
        self.trained_point_weight = nn.Parameter(torch.rand(H))
        self.scalar_query = nn.Linear(d_model, H * dk, bias=False)
        self.scalar_key = nn.Linear(d_model, H * dk, bias=False)
        self.scalar_value = nn.Linear(d_model, H * dk, bias=False)
        self.pair_bias = nn.Linear(d_pair, H, bias=False)
        self.point_query = nn.Linear(d_model, H * 4 * 3, bias=False)
        self.point_key = nn.Linear(d_model, H * 4 * 3, bias=False)
        self.point_value = nn.Linear(d_model, H * 8 * 3, bias=False)
        self.pair_value = HeadwiseLinear(d_pair, H * dk, H)
        self.fc_out = nn.Linear(2 * H * dk + H * 8 * 3 + H * 8, d_model)
        self.dropout = nn.Dropout(dropout)

    def forward(
        self,
        x1d: torch.Tensor,               # [B, L, C]
        x2d: torch.Tensor,               # [B, n, L, Cp]
        pose: tuple[torch.Tensor, torch.Tensor],  # (T [B, L, 3], IR [B, L, 3, 3])
        bias: torch.Tensor,              # [B, L] f32 column bias (NEG_INF masked)
        pa: torch.Tensor | None,         # [B, H, n, L] pair bias x2d @ w_pb, unscaled
        rows: tuple[int, int],
    ) -> torch.Tensor:
        """Attention output ``[B, n, C]`` for the query rows ``rows = (r0,
        r1)``, ``n = r1 - r0``: the rows that ``x2d`` and ``pa`` hold (the
        rank's slab under SP, else ``(0, L)``). Keys and values are all
        ``L`` rows of ``x1d``. With ``pa`` None the kernel computes the pair
        bias from ``x2d`` and ``pair_bias.weight``."""
        H, dk, dt = self.n_head, self.head_dim, self.dtype
        B, L, _ = x1d.shape
        x1d = copy_in(x1d, self.tp)
        # The module receives inverse rotations; transpose back to rotations.
        T = copy_in(pose[0], self.tp).float()
        R = copy_in(pose[1], self.tp).transpose(-1, -2).float()
        r0, r1 = rows
        xq, Tq, Rq = x1d[:, r0:r1], T[:, r0:r1], R[:, r0:r1]
        n = r1 - r0

        def head_major(x: torch.Tensor) -> torch.Tensor:  # [B, L, H, c] -> [B, H, L, c]
            return x.permute(0, 2, 1, 3).contiguous()

        q_s = head_major(_linear(xq, self.scalar_query, dt).reshape(B, n, H, dk))
        k_s = head_major(_linear(x1d, self.scalar_key, dt).reshape(B, L, H, dk))
        v_s = head_major(_linear(x1d, self.scalar_value, dt).reshape(B, L, H, dk))

        def global_points(x, rot, trans, lin: nn.Linear, npts: int) -> torch.Tensor:
            # Weight rows are (head, point, xyz); R x + T in f32.
            p = _linear(x, lin, dt).reshape(B, x.shape[1], H, npts, 3).float()
            return torch.einsum("blxy,blhpy->blhpx", rot, p) + trans[:, :, None, None, :]

        point_weight = math.sqrt(2.0 / (3 * 4 * 9)) * F.softplus(self.trained_point_weight)
        pw = (0.5 * point_weight).float()

        def planes(p: torch.Tensor) -> torch.Tensor:
            # [B, l, H, 4, 3] -> the kernel's [B, 3, H*4, l], scaled by pw[h].
            p = p * pw[None, None, :, None, None]
            return p.permute(0, 4, 2, 3, 1).reshape(B, 3, H * 4, p.shape[1]).contiguous()

        q_p = planes(global_points(xq, Rq, Tq, self.point_query, 4))
        k_p = planes(global_points(x1d, R, T, self.point_key, 4))
        v_point = global_points(x1d, R, T, self.point_value, 8)  # [B, L, H, 8, 3] f32
        v_p = v_point.permute(0, 2, 1, 3, 4).reshape(B, H, L, 24).contiguous()
        w_pb = None if pa is not None else self.pair_bias.weight.float().t().contiguous()
        args = (q_s, k_s, v_s, q_p, k_p, v_p, x2d, self.pair_value.head_major_weight(dt), bias,
                pa, w_pb)
        os_hm, op_hm, opr_hm = sp_ipa_attention(
            rows, *args, scalar_w=1.0 / math.sqrt(3 * dk), pair_w=1.0 / math.sqrt(3)
        )
        out_scalar = os_hm.permute(0, 2, 1, 3).reshape(B, n, H * dk).to(dt)
        out_pair = opr_hm.permute(0, 2, 1, 3).reshape(B, n, H * dk).to(dt)
        out_point_g = op_hm.permute(0, 2, 1, 3).reshape(B, n, H, 8, 3)  # f32

        # Global -> local frame: R^T (x - T).
        out_point_local = torch.einsum(
            "blxy,blhpx->blhpy", Rq, out_point_g - Tq[:, :, None, None, :]
        ).to(dt)
        out_point_norm = torch.sqrt(out_point_local.square().sum(-1) + 1e-12)
        out_feat = torch.cat(
            [
                out_scalar,
                out_point_local.reshape(B, n, H * 24),
                out_pair,
                out_point_norm.reshape(B, n, H * 8),
            ],
            dim=-1,
        )
        return self.dropout(_split_in_linear(out_feat, self.fc_out, dt, self.tp))


class SAEncoderLayer(nn.Module):
    """Pre-LN IPA + MLP residual block (structure_module.py:223-249)."""

    def __init__(self, d_model: int, d_pair: int, n_head: int, dim_feedforward: int,
                 dropout: float, dtype: torch.dtype = torch.float32,
                 tp: MeshContext | None = None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(d_model)
        self.attn = SAAttention(d_model, d_pair, n_head, dropout, dtype, tp)
        self.norm2 = nn.LayerNorm(d_model)
        self.ffn = FeedForward(d_model, dim_feedforward, dropout, dtype, tp)

    def forward(self, x1d, x2d, pose, bias, pa, sp: RankContext | None = None):
        """Attention, the residuals and the FFN on the query rows: all of
        them, or under ``sp`` the rank's row slab, after which the full
        residual stream is gathered from every rank's slab."""
        L = x1d.shape[1]
        r0, r1 = (0, L) if sp is None else sp.rows(L)
        h = _layer_norm(x1d, self.norm1, self.dtype)
        x = x1d[:, r0:r1] + self.attn(h, x2d, pose, bias, pa, (r0, r1))
        x = x + self.ffn(_layer_norm(x, self.norm2, self.dtype))
        return x if sp is None else gather_rows(x, r0, r1, L, dim=1, group=sp.group)


class SAEncoder(nn.Module):
    """Holds the layer stack under the reference's ``encoder.layers`` names."""

    def __init__(self, layers: list[SAEncoderLayer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class StructureModule(nn.Module):
    """IPA encoder stack + diff head (structure_module.py:252-287)."""

    def __init__(self, d_model: int, d_pair: int, n_layer: int, n_head: int,
                 dim_feedforward: int, dropout: float, dtype: torch.dtype = torch.float32,
                 tp: MeshContext | None = None):
        super().__init__()
        self.n_layer = n_layer
        self.encoder = SAEncoder([
            SAEncoderLayer(d_model, d_pair, n_head, dim_feedforward, dropout, dtype, tp)
            for _ in range(n_layer)
        ])
        self.diff_head = DiffHead(d_model)

    def forward(self, pose, x1d, x2d, bias, pa, sp: RankContext | None = None):
        """``pa [n_layer, B, H, n, L]``: the per-layer pair biases of the
        query rows (all ``L``, or the rank's slab under ``sp``), or None for
        the in-kernel pair bias."""
        for i, layer in enumerate(self.encoder.layers):
            x1d = layer(x1d, x2d, pose, bias, None if pa is None else pa[i], sp)
        return self.diff_head(x1d)


class DistributionalGraphormer(nn.Module):
    """Dense-batch DiG model (models.py:148-322).

    Inputs: noisy translations ``T_perturbed [B, L, 3]``, inverse rotations
    ``IR_perturbed [B, L, 3, 3]``, times ``t [B]`` (already scaled by 1000),
    Evoformer ``single [B, L, 384]`` / ``pair [B, L, L, 128]`` and a validity
    ``mask [B, L]`` (True = real residue). Returns ``(T_eps, IR_eps)``, both
    ``[B, L, 3]``.
    """

    def __init__(self, dim_model: int = 512, dim_pair: int = 256, num_layers: int = 8,
                 num_heads: int = 32, dim_single_rep: int = 64, dim_hidden: int = 1024,
                 num_buckets: int = 64, max_distance_relative: int = 128,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32,
                 sp: RankContext | None = None, tp: MeshContext | None = None):
        super().__init__()
        if sp is not None and tp is not None:
            raise ValueError("a model takes sequence or tensor parallelism, not both")
        self.dtype = dtype
        self.sp, self.tp = sp, tp
        self.x1d_proj = nn.Sequential(
            nn.LayerNorm(EVOFORMER_NODE_DIM), nn.Linear(EVOFORMER_NODE_DIM, dim_model, bias=False)
        )
        self.step_emb = SinusoidalPositionEmbedder(dim_model)
        self.x2d_proj = nn.Sequential(
            nn.LayerNorm(EVOFORMER_EDGE_DIM), nn.Linear(EVOFORMER_EDGE_DIM, dim_pair, bias=False)
        )
        self.rp_proj = RelativePositionBias(num_buckets, max_distance_relative, dim_pair)
        self.st_module = StructureModule(
            dim_model, dim_pair, num_layers, num_heads, dim_hidden, dropout, dtype, tp
        )

    def embed_conditioning(
        self, single_repr: torch.Tensor, pair_repr: torch.Tensor,
        mask: torch.Tensor | None = None, with_pa: bool = True,
    ) -> dict:
        """Everything the score net needs that does not depend on ``t`` or
        the pose: projected single/pair conditioning, the column bias and the
        per-layer pair biases ``pa[i] = x2d @ w_pb[i]`` (unscaled; the kernel
        applies ``pair_w``). Computed once per batch; the solver replays only
        :meth:`score_from_cache`. With ``with_pa=False`` the cache holds no
        ``"pa"`` and every layer's kernel computes its pair bias from ``x2d``
        (the JAX package's cache without ``pa``, dig.py:707-751).

        Under SP only the rank's row slab ``r0:r1`` of ``x2d`` and ``pa`` is
        built, from ``pair_repr[:, r0:r1]``. Under TP ``pa`` holds the rank's
        heads, from its rows of every layer's ``pair_bias``."""
        dt = self.dtype
        B, L = pair_repr.shape[:2]
        dev = pair_repr.device
        if mask is None:
            mask = torch.ones((B, L), dtype=torch.bool, device=dev)
        pos_seq = torch.arange(L, device=dev)
        query_seq = pos_seq
        if self.sp is not None:
            r0, r1 = self.sp.rows(L)
            pair_repr, query_seq = pair_repr[:, r0:r1], pos_seq[r0:r1]

        x1d = _linear(_layer_norm(single_repr, self.x1d_proj[0], dt), self.x1d_proj[1], dt)
        # Under TP x2d feeds only the rank's heads: copy_in sums the partial
        # gradients of the parameters that build it.
        ln, lin = self.x2d_proj
        w_ln, b_ln, w_x2d, w_rp = copy_in(
            (ln.weight, ln.bias, lin.weight, self.rp_proj.relative_attention_bias.weight), self.tp)
        x2d = F.layer_norm(pair_repr.float(), ln.normalized_shape, w_ln, b_ln, ln.eps).to(dt)
        x2d = F.linear(x2d, w_x2d.to(dt))
        rel_pos = query_seq[:, None] - pos_seq[None, :]
        x2d = (x2d.float() + self.rp_proj(rel_pos, w_rp)[None]).to(dt).contiguous()

        # Column bias: NEG_INF at masked columns; a fully masked row falls
        # back to no masking to keep the softmax finite (models.py:286-291).
        any_real = mask.any(dim=-1, keepdim=True)
        bias = torch.where(~mask & any_real, NEG_INF, 0.0).to(torch.float32).contiguous()

        cache = {"x1d": x1d, "x2d": x2d, "bias": bias}
        if with_pa:
            cache["pa"] = torch.stack([
                torch.einsum("bijp,hp->bhij", x2d, layer.attn.pair_bias.weight.to(dt))
                for layer in self.st_module.encoder.layers
            ]).contiguous()                                  # [n_layer, B, H, n, L]
        return cache

    def score_from_cache(
        self, T_perturbed: torch.Tensor, IR_perturbed: torch.Tensor, t: torch.Tensor,
        cache: dict, trunk_fn=None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-step score evaluation against a conditioning cache.

        ``trunk_fn`` optionally replaces the IPA stack and its diff head
        (the call contract of ``self.st_module``), so that another schedule
        of the layers, such as the pipeline-parallel trunk
        (``parallel/pipeline.py``), reuses this method's DiG conventions."""
        x1d = (cache["x1d"].float() + self.step_emb(t)[:, None]).to(self.dtype)
        trunk = self.st_module if trunk_fn is None else trunk_fn
        T_eps, IR_eps = trunk(
            (T_perturbed, IR_perturbed), x1d, cache["x2d"], cache["bias"], cache.get("pa"), self.sp,
        )
        # Orientation dependence of the translation score (models.py:305).
        T_eps = torch.einsum("blyx,bly->blx", IR_perturbed.float(), T_eps)
        return T_eps, IR_eps

    def forward(self, T_perturbed, IR_perturbed, t, single_repr, pair_repr, mask=None):
        cache = self.embed_conditioning(single_repr, pair_repr, mask)
        return self.score_from_cache(T_perturbed, IR_perturbed, t, cache)


class DiGConditionalScoreModel(nn.Module):
    """Wrapper with the DiG conventions (models.py:325-384): ``t`` is scaled
    by 1000 and rotations are fed transposed (inverse). Returns raw
    ``(pos_out, rot_out)``: the translation output predicts ``score * std``
    and the rotation output ``score / score_scaling``."""

    def __init__(self, dim_model: int = 512, dim_pair: int = 256, num_layers: int = 8,
                 num_heads: int = 32, dim_single_rep: int = 64, dim_hidden: int = 1024,
                 num_buckets: int = 64, max_distance_relative: int = 128,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32,
                 sp: RankContext | None = None, tp: MeshContext | None = None):
        super().__init__()
        self.model_nn = DistributionalGraphormer(
            dim_model, dim_pair, num_layers, num_heads, dim_single_rep, dim_hidden,
            num_buckets, max_distance_relative, dropout, dtype, sp, tp,
        )

    def embed_conditioning(self, single_repr, pair_repr, mask=None, with_pa: bool = True) -> dict:
        """The t-invariant conditioning, for :meth:`score_from_cache`."""
        return self.model_nn.embed_conditioning(single_repr, pair_repr, mask, with_pa)

    def score_from_cache(self, pos, rot, t, cache, trunk_fn=None):
        return self.model_nn.score_from_cache(pos, rot.transpose(-1, -2), t * 1000.0, cache,
                                              trunk_fn)

    def forward(self, pos, rot, t, single_repr, pair_repr, mask=None):
        return self.model_nn(
            pos, rot.transpose(-1, -2), t * 1000.0, single_repr, pair_repr, mask
        )


def count_params(model: nn.Module) -> int:
    """Number of parameter elements (the JAX package's ``count_params`` on
    the same weights); buffers such as the empty ``step_emb.dummy`` sentinel
    are not parameters."""
    return sum(p.numel() for p in model.parameters())


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter from ``generator`` with the JAX package's
    initialisers: truncated-normal LeCun for projections, normal(1/sqrt(dim))
    for embeddings, uniform[0, 1) for point weights, ones/zeros for layer
    norms and biases. Returns ``model``."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "trained_point_weight":
                p.uniform_(0.0, 1.0, generator=generator)
            elif "relative_attention_bias" in name:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
            elif p.ndim == 1:
                p.fill_(1.0 if leaf == "weight" else 0.0)
            else:
                # LeCun normal truncated at 2 sigma (variance-corrected).
                std = 1.0 / math.sqrt(p.shape[1]) / 0.87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)
    return model
