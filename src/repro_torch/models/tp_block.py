"""The reference's default tensor parallelism written out by hand: what
GSPMD makes of ``repro/models/model.py`` ``_dense_block`` (its
``layers.attention``, ``layers.mla_attention`` and ``layers.mlp``)
under ``param_pspecs`` and the ``residual`` / ``block_input`` /
``logit_hidden`` constraints of ``repro/dist/steps.py``
``_constraint_fn``, on a model line of n ranks.

The residual between blocks (:class:`SeqLine`): sequence-sharded, rank
r holding rows ``[r·S/n, (r+1)·S/n)``, when ``sequence_parallel`` is set
and n divides S (a VLM's S counting its patch rows, which come first);
else whole on every rank, as the reference's constraint replicates it.

A block:

  column-parallel groups (``wq``/``wk``/``wv``, ``w_up``/``w_gate``,
  MLA's ``w_dq``, ``w_dkv``, ``w_uq``, ``w_uk``, ``w_uv``): the normed
  input gathered over S (``all_gather``; nothing to gather when the
  residual is whole), then its product with the rank's columns;
  row-parallel groups (``wo``, ``w_down``): the product with the rank's
  rows, then ``reduce_scatter`` over S, or ``all_reduce`` when the
  residual is whole (in fp32, cast back to the residual's dtype).

Every collective is the line's plain one on the conduit's ``xla``
transport (gloo, differentiable: a gather's backward is the scatter,
an all-reduce's the all-reduce), and every product ``torch.matmul``.
The block's arithmetic is ``layers``' own (``qkv_proj``, ``mla_q``,
``mla_latent``, ``mla_expand``, ``mlp``), run on the rank's weights
under a config of the rank's heads; this module only slices and gathers.

Heads.  Rank r takes rows ``[r·K/n, (r+1)·K/n)`` of ``wo`` (K = heads ×
the value head dim), its own rows when ``wo`` is split and a slice of the
whole leaf when ``fit_axis`` kept it whole.  It attends with the whole
heads those rows cover — more than its share where the split cuts a head
(``smollm-360m``'s 15 heads at tp 2: heads 0–7 on rank 0, 7–14 on rank
1) — and keeps the output columns its rows take.  Each column projection
then gives the columns of those heads (for K/V the KV heads they read):
where every rank's columns are its own (the heads, and the GQA groups,
split evenly) the rank's shard is used as it is; otherwise the rank
gathers that weight's columns over the line (``all_gather`` of the
(D, N/n) shard, whose backward reduce-scatters the weight gradient to
its owner) and multiplies by the columns it needs.  The gather is of the
weight, not the product: D × N × (n − 1)/n elements a rank a layer,
whatever the batch (at tp 2 on ``smollm-360m`` ``wq``, ``wk`` and
``wv``, 1.5 MB a rank a layer in bf16, forward; the same reduce-scattered
in backward), where the product's columns would be B × S × N.  A leaf
``fit_axis`` kept whole is sliced.

MLA (``minicpm3``): ``q_norm`` and ``kv_norm`` need the whole latent, and
``w_dkv``'s last ``qk_rope`` columns are the rope key every head shares,
so ``w_dq`` and ``w_dkv`` are gathered whole on every rank (the same
rule: every rank needs every column), the latents normed whole, and
``w_uq``, ``w_uk`` and ``w_uv`` give the rank's heads.  Rope runs on the
gathered sequence's positions, ``arange(S)``.

Gradients follow the port's TP rule (``dist/loss.py``): each rank runs
backward on its share of the loss, the shares summing to the loss; a
sharded leaf's gradient is complete on its rank (from the weight gather's
reduce-scatter where there is one), and a replicated leaf's is this
rank's part, summed over the line by the step.  Under ``remat="full"``
the block, its collectives with it, is recomputed in backward, on every
rank in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.conduit import Conduit
from repro_torch.models import layers as L
from repro_torch.models.model import _embed, project_frontend
from repro_torch.models.vocab_parallel import VocabParallel

Params = Dict[str, Any]


def cut(total: int, n: int, r: int) -> Tuple[int, int]:
    """Rank r's part ``[r·total/n, (r+1)·total/n)`` of ``total`` (floored
    at both ends, so the parts cover it when n does not divide it)."""
    return r * total // n, (r + 1) * total // n


@dataclasses.dataclass(frozen=True)
class SeqLine:
    """How a model line holds a microbatch's sequence: ``conduit`` over
    the line (its transport carries the embedding's scatter), ``sp``
    whether the residual is sequence-sharded (else whole on every rank),
    ``vocab`` the line's vocab split (``models/vocab_parallel.py``) or
    None (``embed`` and ``lm_head`` whole)."""

    conduit: Conduit
    sp: bool
    vocab: Optional[VocabParallel] = None

    @property
    def group(self):
        return self.conduit.axis

    def rows(self, s: int) -> slice:
        """The rows of a length-``s`` sequence this rank's residual
        holds."""
        if not self.sp:
            return slice(None)
        lo, hi = cut(s, self.group.size, self.group.rank)
        return slice(lo, hi)

    def share(self, s: int) -> slice:
        """The rows whose tokens this rank's loss counts: its own rows,
        or with a whole residual its cut of the sequence."""
        lo, hi = cut(s, self.group.size, self.group.rank)
        return slice(lo, hi)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows → the line's whole sequence (``all_gather``
        over S; the rows as they are when the residual is whole)."""
        return self.conduit.all_gather(x, dim=1) if self.sp else x

    def combine(self, part: torch.Tensor, dtype: torch.dtype
                ) -> torch.Tensor:
        """The ranks' partial sums (B, S, D) of a row-parallel product →
        this rank's rows of their sum (``reduce_scatter`` over S, or the
        ``all_reduce`` whole), summed in fp32 and cast to ``dtype``."""
        part = part.float()
        if self.sp:
            return self.conduit.reduce_scatter(part, dim=1).to(dtype)
        return self.conduit.all_reduce(part).to(dtype)

    def embed(self, cfg: ModelConfig, params: Params, tokens: torch.Tensor,
              frontend_embeds: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
        """The line's whole (B, S) ``tokens`` (and a VLM's patches, whose
        projected rows come first) → this rank's residual rows.  With the
        vocab split each rank looks up the ids it holds (zeros for the
        rest; the VLM's patch rows on rank 0 alone, so exactly one rank's
        partial of a row is not zero) and the line reduce-scatters (or,
        whole, all-reduces) the partials: the replicated lookup's rows
        bit for bit."""
        if self.vocab is None:
            x = _embed(cfg, params, tokens, frontend_embeds)
            return x[:, self.rows(x.shape[1])]
        part = self.vocab.partial(params["embed"], tokens)
        if cfg.family == "vlm":
            b, n_patch = frontend_embeds.shape[:2]
            vis = (project_frontend(cfg, params, frontend_embeds)
                   .to(part.dtype) if self.group.rank == 0 else
                   part.new_zeros((b, n_patch, part.shape[-1])))
            part = torch.cat([vis, part], dim=1)
        if self.sp:
            return self.conduit.reduce_scatter(part, dim=1)
        return self.conduit.all_reduce(part.float()).to(part.dtype)


@dataclasses.dataclass(frozen=True)
class _Cols:
    """A column projection's part on this rank: the columns ``[lo, hi)``
    of the logical weight it needs, and whether the line gathers the
    weight for them (some rank needs columns that are not its own)."""

    lo: int
    hi: int
    gather: bool


def _col_plan(place: str, total: int, n: int, r: int,
              need: Callable[[int], Tuple[int, int]]) -> _Cols:
    """:class:`_Cols` of a weight of ``total`` columns placed ``place``,
    rank q needing columns ``need(q)``."""
    lo, hi = need(r)
    gather = place == "col" and any(
        need(q) != cut(total, n, q) for q in range(n))
    return _Cols(lo, hi, gather)


class TPBlock:
    """The dense (GQA or MLA) block of rank ``group.rank`` on its model
    line, for the leaves' placements ``places`` (a layer's, keyed by the
    path inside the layer: ``("attn", "wq")``); :meth:`runner` is the
    block runner ``forward_hidden`` takes."""

    def __init__(self, cfg: ModelConfig, group,
                 places: Dict[Tuple[str, ...], str]):
        self.cfg, self.group, self.places = cfg, group, places
        self.conduit = Conduit(axis=group, transport="xla")
        n, r = group.size, group.rank
        self.cd = L.cdtype(cfg)
        self.core = L.blockwise_core(cfg)
        mla = cfg.attn_type == "mla"
        h = cfg.n_heads
        # heads and output columns from the rows of ``wo`` the rank takes
        width = cfg.v_head_dim if mla else cfg.resolved_head_dim
        rows = h * width

        def heads(q: int) -> Tuple[int, int]:
            a, b = cut(rows, n, q)
            return a // width, -(-b // width)

        self.o_rows = cut(rows, n, r)
        self.heads = heads(r)
        self.o_cols = (self.o_rows[0] - self.heads[0] * width,
                       self.o_rows[1] - self.heads[0] * width)
        cols: Dict[str, _Cols] = {}

        def plan(name: str, total: int, need):
            cols[name] = _col_plan(places[("attn", name)], total, n, r, need)

        if mla:
            dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
            plan("w_dq", cfg.q_lora_rank, lambda q: (0, cfg.q_lora_rank))
            latent = cfg.kv_lora_rank + dr
            plan("w_dkv", latent, lambda q: (0, latent))
            for name, w in (("w_uq", dn + dr), ("w_uk", dn), ("w_uv", dv)):
                plan(name, h * w, lambda q, w=w: tuple(
                    i * w for i in heads(q)))
        else:
            hd = cfg.resolved_head_dim
            group_size = h // cfg.n_kv_heads

            def kv_heads(q: int) -> Tuple[int, int]:
                lo, hi = heads(q)
                return lo // group_size, (hi - 1) // group_size + 1

            plan("wq", h * hd, lambda q: tuple(i * hd for i in heads(q)))
            for name in ("wk", "wv"):
                plan(name, cfg.n_kv_heads * hd,
                     lambda q: tuple(i * hd for i in kv_heads(q)))
            self.kv_heads = kv_heads(r)
            self.group_size = group_size
        self.cols = cols
        # the config of the rank's heads, the shape ``layers`` reads
        lo, hi = self.heads
        self.local_cfg = dataclasses.replace(
            cfg, n_heads=hi - lo, head_dim=cfg.resolved_head_dim,
            **({} if mla else {"n_kv_heads": self.kv_heads[1]
                               - self.kv_heads[0]}))
        self.ff = cut(cfg.d_ff, n, r)

    # -- the rank's weights --------------------------------------------------

    def _cols(self, w: torch.Tensor, place: str, lo: int, hi: int,
              gather: bool = False) -> torch.Tensor:
        """``W[:, lo:hi]`` of the logical weight W whose part on this rank
        is ``w`` (placed ``place``): the rank's own columns, a slice of
        the weight gathered over the line, or a slice of a whole leaf."""
        if place == "col" and not gather:
            return w
        if gather:
            w = self.conduit.all_gather(w, dim=1)
        return w[:, lo:hi]

    def _rows(self, w: torch.Tensor, place: str, lo: int,
              hi: int) -> torch.Tensor:
        """``W[lo:hi]``: the rank's own rows of a row shard, a slice of a
        whole leaf."""
        return w if place == "row" else w[lo:hi]

    def _attn_params(self, p: Params) -> Params:
        """The attention's leaves as the rank's heads see them: each column
        projection's columns of those heads, the norms as they are."""
        out = {k: v for k, v in p.items() if k not in self.cols}
        for name, c in self.cols.items():
            out[name] = self._cols(p[name], self.places[("attn", name)],
                                   c.lo, c.hi, c.gather)
        return out

    # -- attention ----------------------------------------------------------

    def _heads_out(self, p: Params, a: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        """The rank's whole heads' attention outputs (B, h, S, width):
        ``layers``' projections on the rank's weights, under the config
        of those heads."""
        cfg, lcfg = self.cfg, self.local_cfg
        p = self._attn_params(p)
        if cfg.attn_type == "mla":
            q = L.mla_q(lcfg, p, a, positions)
            k, v = L.mla_expand(lcfg, p, *L.mla_latent(lcfg, p, a, positions))
            return self.core(q, k, v, causal=True, scale=L.mla_scale(cfg))
        q, k, v = L.qkv_proj(lcfg, p, a, positions)
        # each of the rank's query heads reads its own KV head
        lo, hi = self.heads
        kv_idx = (torch.arange(lo, hi, device=a.device) // self.group_size
                  - self.kv_heads[0])
        return self.core(q, k.index_select(1, kv_idx),
                         v.index_select(1, kv_idx), causal=True,
                         window=cfg.window)

    def attention(self, p: Params, a: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
        """The gathered normed rows (B, S, D) → this rank's partial
        (B, S, D) of the attention's output projection."""
        out = self._heads_out(p, a, positions)
        b, _, s, _ = out.shape
        flat = out.transpose(1, 2).reshape(b, s, -1)
        wo = self._rows(p["wo"], self.places[("attn", "wo")], *self.o_rows)
        return flat[..., self.o_cols[0]:self.o_cols[1]] @ wo.to(self.cd)

    def mlp(self, p: Params, m: torch.Tensor) -> torch.Tensor:
        """The gathered normed rows → this rank's partial of the MLP (its
        ``d_ff`` columns ``[r·F/n, (r+1)·F/n)``): ``layers.mlp`` on the
        rank's columns of ``w_up``/``w_gate`` and rows of ``w_down``."""
        lo, hi = self.ff
        local = {name: self._cols(p[name], self.places[("mlp", name)], lo,
                                  hi)
                 for name in ("w_up", "w_gate") if name in p}
        local["w_down"] = self._rows(p["w_down"],
                                     self.places[("mlp", "w_down")], lo, hi)
        return L.mlp(self.cfg, local, m)

    def runner(self, line: SeqLine) -> Callable:
        """The block runner over ``line``'s layout: ``runner(cfg,
        layer_params, x, positions)`` with x this rank's residual rows and
        ``positions`` the whole sequence's."""
        def run(cfg, lp, x, positions):
            a = line.gather(L.apply_norm(cfg, lp["ln1"], x))
            h = x + line.combine(self.attention(lp["attn"], a, positions),
                                 x.dtype)
            m = line.gather(L.apply_norm(cfg, lp["ln2"], h))
            return h + line.combine(self.mlp(lp["mlp"], m), h.dtype)

        return run


__all__ = ["SeqLine", "TPBlock", "cut"]
