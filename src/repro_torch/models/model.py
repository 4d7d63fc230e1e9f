"""LanguageModel: every family of :mod:`repro.models.model` (dense, MoE,
SSM, hybrid, vision, audio) as an ``nn.Module`` holding its weights, for
serving.

Every layer is ``ln1 → mixer → [ln_cross → cross] → ln2 → ffn`` with
residuals.  The mixer is GQA attention (``pad_heads`` included), MLA
(``cfg.attention == "mla"``) or Mamba-2 by ``cfg.layer_kind``; a layer
where ``cfg.layer_is_cross_attn`` adds the gated cross-attention over the
vision embeddings; the FFN is the MoE layer
(:func:`repro_torch.models.moe.moe_ffn`) where ``cfg.layer_is_moe``, else
the dense FFN.  The audio family embeds ``[B,S,K]`` codebook tokens as the
sum of ``K`` embeddings and unembeds to ``[B,S,K,V]`` logits.  The layers
run as a Python loop over per-layer weights (the reference stacks its
periodic body and scans it; :meth:`LanguageModel.structure` gives that
period, which :func:`repro_torch.models.params.from_reference` needs to
read the reference's stacked tree).  The multi-token-prediction block
(``cfg.mtp_depth``) is held, so the parameter tree is the reference's
whole; only the training loss reads it.

Serving (:meth:`LanguageModel.forward`, :meth:`LanguageModel.decode_step`)
runs under ``torch.no_grad``.  Training goes through
:meth:`LanguageModel.loss` (``mode="train"``): the same blocks with
gradients, each under ``torch.utils.checkpoint`` where ``cfg.remat``, so
B4 and B5 run as their autograd Functions (``FlashAttention``,
``SSDChunkDual``) with hand-written backward kernels on the card.  The
loss is the reference's: cross-entropy (chunked along the sequence where
``cfg.loss_chunk`` divides it), the MoE routing losses and the MTP loss.

A zero-width FFN (``d_ff = 0``, as mamba2_780m has) is kept: it adds
exact zeros after ``ln2``, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.graph import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ffn, ffn_specs, rmsnorm, rmsnorm_specs
from repro_torch.models.moe import moe_ffn, moe_specs
from repro_torch.models.params import (ParamSpec, init_params, map_tree,
                                      shard_if)

#: the modes the port runs: ``forward`` prefills, ``decode_step`` decodes,
#: ``loss`` trains
MODES = ("prefill", "decode", "train")
#: the loss's weights of the MoE routing losses and of the MTP loss (the
#: reference's)
MOE_LB_COEF = 0.01
MOE_Z_COEF = 1e-3
MTP_COEF = 0.3


def check_supported(cfg: ModelConfig, mode: str = "prefill") -> None:
    """Raise for a mode the port does not know.  Every config is served
    and trained."""
    if mode not in MODES:
        raise ValueError(f"{cfg.name}: mode={mode!r} is not one of "
                         f"{MODES}")


def layer_sigs(cfg: ModelConfig) -> list:
    """Each layer's ``(kind, is_moe, is_cross)``: the reference's
    ``LayerSig``."""
    return [(cfg.layer_kind(i), cfg.layer_is_moe(i),
             cfg.layer_is_cross_attn(i)) for i in range(cfg.num_layers)]


def _fsdp(cfg: ModelConfig):
    """ZeRO-3-style parameter sharding over the data axis for the giants
    (the reference's ``LanguageModel._fsdp``)."""
    return "data" if cfg.fsdp else None


def block_specs(cfg: ModelConfig, kind: str, is_moe: bool,
                is_cross: bool = False) -> dict:
    fsdp = _fsdp(cfg)
    if kind != "attn":
        mixer = mb.mamba_specs(cfg, fsdp)
    elif cfg.attention == "mla":
        mixer = attn.mla_specs(cfg, fsdp)
    else:
        mixer = attn.gqa_specs(cfg, fsdp)
    block = {"ln1": rmsnorm_specs(cfg.d_model), "mixer": mixer,
             "ln2": rmsnorm_specs(cfg.d_model)}
    if is_moe:
        block["moe"] = moe_specs(cfg, fsdp)
    else:
        block["ffn"] = ffn_specs(cfg.d_model, cfg.d_ff,
                                 activation=cfg.ffn_activation, fsdp=fsdp,
                                 dtype=cfg.dtype)
    if is_cross:
        block["ln_cross"] = rmsnorm_specs(cfg.d_model)
        block["cross"] = attn.cross_attn_specs(cfg, fsdp)
    return block


def model_param_specs(cfg: ModelConfig) -> dict:
    """The spec tree: ``embed`` ([V,D], audio [K,V,D]), ``final_norm``,
    ``layers`` (one block per layer), ``lm_head`` ([D,V], audio [K,D,V])
    unless the embeddings are tied, and ``mtp`` where ``cfg.mtp_depth``.
    The vocabulary lies over ``model`` where 16 divide it, else d_model
    does; ``fsdp`` takes d_model first."""
    v, d = cfg.vocab_size, cfg.d_model
    fsdp = _fsdp(cfg)
    tp_v = shard_if(v, "model", 16)
    d_ax = fsdp or (None if tp_v else shard_if(d, "model", 16))
    if cfg.family == "audio":
        embed = ParamSpec((cfg.num_codebooks, v, d), cfg.dtype, "scaled",
                          scale=d ** 0.5, pspec=(None, tp_v, d_ax))
        head = ParamSpec((cfg.num_codebooks, d, v), cfg.dtype, "scaled",
                         pspec=(None, d_ax, tp_v))
    else:
        embed = ParamSpec((v, d), cfg.dtype, "scaled", scale=d ** 0.5,
                          pspec=(tp_v, d_ax))
        head = ParamSpec((d, v), cfg.dtype, "scaled", pspec=(d_ax, tp_v))
    sigs = layer_sigs(cfg)
    specs = {
        "embed": embed,
        "final_norm": rmsnorm_specs(d),
        "layers": [block_specs(cfg, *sig) for sig in sigs],
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = head
    if cfg.mtp_depth:
        specs["mtp"] = {
            "norm_h": rmsnorm_specs(d),
            "norm_e": rmsnorm_specs(d),
            "proj": ParamSpec((2 * d, d), cfg.dtype, "scaled",
                              pspec=(fsdp, None)),
            "block": block_specs(cfg, *sigs[-1]),
        }
    return specs


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: dict entries become
    submodules, tensors become parameters (created without gradients:
    training turns them on, ``LanguageModel.requires_grad_``).
    ``tree[key]`` reads like the reference's parameter dicts."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            else:
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def items(self):
        return self.tree().items()

    def tree(self) -> dict:
        return {k: (v.tree() if isinstance(v, ParamTree) else v)
                for k, v in {**dict(self.named_children()),
                             **dict(self.named_parameters(
                                 recurse=False))}.items()}


class LanguageModel(nn.Module):
    """``LanguageModel(cfg, seed=0, device="cuda")``: the model with
    weights from :func:`init_params` (seeded, made on the CPU and moved to
    ``device``, so a seed gives the same weights on every device).
    ``device="cuda"`` without a card raises.  ``device="meta"`` builds the
    abstract model of the dry run: every weight a meta tensor, none
    drawn."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device, allow_meta=True)
        self.cfg = cfg
        self.sigs = layer_sigs(cfg)
        self.is_moe = [sig[1] for sig in self.sigs]
        self.is_cross = [sig[2] for sig in self.sigs]
        params = init_params(model_param_specs(cfg),
                             torch.Generator().manual_seed(seed),
                             device="meta" if dev.type == "meta" else "cpu")
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.final_norm = ParamTree(params["final_norm"])
        self.layers = nn.ModuleList(ParamTree(b) for b in params["layers"])
        if "lm_head" in params:
            self.lm_head = nn.Parameter(params["lm_head"],
                                        requires_grad=False)
        if "mtp" in params:
            self.mtp = ParamTree(params["mtp"])
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def to_device(self, device="cuda") -> "LanguageModel":
        """Move the weights to ``device`` (in place); a CUDA request
        without a card raises."""
        return self.to(resolve_device(device))

    def param_tree(self) -> dict:
        """The weights as the nested dict of :func:`model_param_specs`."""
        tree = {"embed": self.embed, "final_norm": self.final_norm.tree(),
                "layers": [blk.tree() for blk in self.layers]}
        if not self.cfg.tie_embeddings:
            tree["lm_head"] = self.lm_head
        if self.cfg.mtp_depth:
            tree["mtp"] = self.mtp.tree()
        return tree

    def structure(self) -> tuple[int, int]:
        """``(prefix_len, period)`` of the reference's layer program: the
        smallest prefix + period after which the layers' signatures
        (mixer kind, MoE or not, cross-attention or not) repeat."""
        L = self.cfg.num_layers
        best, best_cost = (L, 1), L + 1
        for period in range(1, L + 1):
            for prefix in range(L):
                body = self.sigs[prefix:]
                if len(body) % period:
                    continue
                if prefix + period >= best_cost:
                    break
                if all(body[i] == body[i % period] for i in range(len(body))):
                    best, best_cost = (prefix, period), prefix + period
                    break
        return best

    # ------------------------------------------------------------------
    def cache_specs(self, batch: int, max_len: int, seq_axis=None) -> dict:
        """The cache's spec tree: one flat dict per layer (GQA ``k``/``v``
        [batch,Hkv,max_len,hd]; MLA ``c_kv`` [batch,max_len,kvr] and
        ``k_rope`` [batch,max_len,dr]; Mamba ``ssm`` and conv windows; a
        cross layer also ``cross_k``/``cross_v`` [batch,Hkv,T,hd] of the
        image tokens); every leaf has the batch on axis 0.  ``seq_axis``
        shards an attention cache's sequence (one long sequence)."""
        cfg = self.cfg
        layers = []
        for kind, _, is_cross in self.sigs:
            if kind != "attn":
                specs = mb.mamba_cache_specs(cfg, batch)
            elif cfg.attention == "mla":
                specs = attn.mla_cache_specs(cfg, batch, max_len, seq_axis)
            else:
                specs = attn.gqa_cache_specs(cfg, batch, max_len, seq_axis)
            if is_cross:
                specs.update({f"cross_{k}": s for k, s in
                              attn.cross_cache_specs(cfg, batch).items()})
            layers.append(specs)
        return {"layers": layers}

    def new_cache(self, batch: int, max_len: int) -> dict:
        """A zeroed cache of :meth:`cache_specs` on the model's device."""
        return map_tree(lambda _, s: torch.zeros(
            s.shape, dtype=s.torch_dtype, device=self.device),
            self.cache_specs(batch, max_len))

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B,S] -> [B,S,D]; audio [B,S,K] -> the sum of the K
        codebooks' embeddings, in the embeddings' dtype."""
        if self.cfg.family == "audio":
            return sum(self.embed[k][tokens[..., k]]
                       for k in range(self.cfg.num_codebooks))
        return self.embed[tokens]

    def unembed(self, h: torch.Tensor) -> torch.Tensor:
        """[B,S,D] -> logits [B,S,V]; audio [B,S,K,V]."""
        audio = self.cfg.family == "audio"
        if self.cfg.tie_embeddings:
            if audio:
                return torch.einsum("bsd,kvd->bskv", h, self.embed)
            return h @ self.embed.T
        if audio:
            return torch.einsum("bsd,kdv->bskv", h, self.lm_head)
        return h @ self.lm_head

    def _mixer(self, p, kind: str, hn, positions, c, mode: str, position):
        cfg = self.cfg
        if kind != "attn":
            if mode == "decode":
                return mb.mamba_decode(p, cfg, hn, c)[0]
            return mb.mamba_forward(p, cfg, hn, c)[0]
        if cfg.attention == "mla":
            if mode == "decode":
                return attn.mla_decode(p, cfg, hn, position, c)[0]
            return attn.mla_forward(p, cfg, hn, positions, c)[0]
        if mode == "decode":
            return attn.gqa_decode(p, cfg, hn, position, c)[0]
        return attn.gqa_forward(p, cfg, hn, positions, c)[0]

    def _cross(self, p, h, vision, c, mode: str):
        """The gated cross-attention of a block ``p``; its cache is the
        layer's ``cross_k``/``cross_v`` (the same tensors, written in
        place)."""
        cfg = self.cfg
        hc = rmsnorm(p["ln_cross"], h)
        cc = None if c is None else {"k": c["cross_k"], "v": c["cross_v"]}
        if mode == "decode":
            return attn.cross_attn_decode(p["cross"], cfg, hc, cc)[0]
        return attn.cross_attn_forward(p["cross"], cfg, hc, vision, cc)[0]

    def _block(self, i: int, h, positions, cache, mode: str, position,
               vision=None):
        """Layer ``i`` -> ``(h, aux)``: ``aux`` is :func:`moe_ffn`'s for an
        MoE layer (its routing included), else None."""
        c = cache["layers"][i] if cache is not None else None
        return self._apply_block(self.layers[i], self.sigs[i], h,
                                 positions, c, mode, position, vision)

    def _apply_block(self, p, sig, h, positions, c, mode: str, position,
                     vision=None):
        """The block of parameters ``p`` and signature ``sig`` (kind,
        is_moe, is_cross) -> ``(h, aux)``."""
        cfg = self.cfg
        kind, is_moe, is_cross = sig
        h = h + self._mixer(p["mixer"], kind, rmsnorm(p["ln1"], h),
                            positions, c, mode, position)
        if is_cross:
            h = h + self._cross(p, h, vision, c, mode)
        hn = rmsnorm(p["ln2"], h)
        if not is_moe:
            return h + ffn(p["ffn"], hn, activation=cfg.ffn_activation), None
        out, aux = moe_ffn(p["moe"], cfg, hn)
        return h + out, aux

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *, mode: str = "prefill",
                cache: Optional[dict] = None,
                vision_embeds: Optional[torch.Tensor] = None):
        """tokens [B,S] (audio [B,S,K]) -> (logits [B,S,V] (audio
        [B,S,K,V]), cache).  With a cache (from :meth:`new_cache`,
        capacity >= S) this is the prefill that fills it; the cache is
        updated in place and returned.  A vision config takes the stub
        frontend's ``vision_embeds`` [B,T,D], cast to the model's
        dtype."""
        check_supported(self.cfg, mode)
        if mode != "prefill":
            raise ValueError("forward runs a prefill: decode through "
                             "decode_step, train through loss")
        if any(self.is_cross) and vision_embeds is None:
            raise ValueError(f"{self.cfg.name} has cross-attention layers: "
                             f"pass vision_embeds [B,T,D]")
        if vision_embeds is not None:
            vision_embeds = vision_embeds.to(self.embed.dtype)
        h = self.embed_tokens(tokens)
        B, S = tokens.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        for i in range(self.cfg.num_layers):
            h, _ = self._block(i, h, positions, cache, "prefill", None,
                               vision_embeds)
        h = rmsnorm(self.final_norm, h)
        return self.unembed(h), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor, position):
        """tokens [B,1] (audio [B,1,K]); ``position`` an int (lockstep) or
        a [B] tensor (ragged slots).  Returns (logits [B,1,V] (audio
        [B,1,K,V]), cache updated in place).  Cross layers attend to the
        image K/V their prefill cached."""
        h = self.embed_tokens(tokens)
        for i in range(self.cfg.num_layers):
            h, _ = self._block(i, h, None, cache, "decode", position)
        h = rmsnorm(self.final_norm, h)
        return self.unembed(h), cache

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def aux_layers(self) -> list:
        """The layers whose MoE routing losses enter the loss: the
        reference adds each prefix layer's, but of its scanned body only
        the last block of each period (``aux_c = _acc(aux_c, aux)`` after
        the loop over the period's blocks), so a period with several MoE
        layers (jamba) contributes one of them.  The port keeps that
        rule, since it is the loss the two packages compare."""
        prefix, period = self.structure()
        return [i for i in range(self.cfg.num_layers)
                if i < prefix or (i - prefix) % period == period - 1]

    def _train_block(self, i: int, h, positions, vision):
        """Layer ``i`` with gradients -> ``(h, lb_loss, z_loss)``, the
        routing losses zero for a dense layer."""
        h, aux = self._block(i, h, positions, None, "train", None, vision)
        if aux is None:
            zero = torch.zeros((), dtype=torch.float32, device=h.device)
            return h, zero, zero
        return h, aux["lb_loss"], aux["z_loss"]

    def hidden(self, tokens: torch.Tensor, vision_embeds=None):
        """The training trunk: tokens [B,S] (audio [B,S,K]) -> (the final
        normed hidden states [B,S,D], lb_loss, z_loss summed under
        :meth:`aux_layers`' rule), with gradients; each layer under
        ``torch.utils.checkpoint`` (non-reentrant) where ``cfg.remat``."""
        if any(self.is_cross) and vision_embeds is None:
            raise ValueError(f"{self.cfg.name} has cross-attention layers: "
                             f"pass vision_embeds [B,T,D]")
        if vision_embeds is not None:
            vision_embeds = vision_embeds.to(self.embed.dtype)
        h = self.embed_tokens(tokens)
        B, S = tokens.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        counted = set(self.aux_layers())
        lb = z = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(self.cfg.num_layers):
            if self.cfg.remat:
                h, lb_i, z_i = checkpoint(self._train_block, i, h, positions,
                                          vision_embeds, use_reentrant=False)
            else:
                h, lb_i, z_i = self._train_block(i, h, positions,
                                                 vision_embeds)
            if i in counted:
                lb, z = lb + lb_i, z + z_i
        return rmsnorm(self.final_norm, h), lb, z

    def loss(self, batch: dict):
        """The training objective of ``batch`` (``tokens``, ``labels``
        [B,S] (audio [B,S,K]), ``vision_embeds`` for a vision config) ->
        ``(total, metrics)``: mean cross-entropy (``ce_loss``), plus
        ``MOE_LB_COEF·lb_loss + MOE_Z_COEF·z_loss`` for an MoE config and
        ``MTP_COEF·mtp_loss`` where ``cfg.mtp_depth``; ``metrics`` holds
        each term and ``loss`` (detached, float32 0-d tensors)."""
        cfg = self.cfg
        labels = batch["labels"]
        h, lb, z = self.hidden(batch["tokens"], batch.get("vision_embeds"))
        S = labels.shape[1]
        if cfg.loss_chunk and S % cfg.loss_chunk == 0:
            main = self._chunked_xent(h, labels, cfg.loss_chunk)
        else:
            main = _xent(self.unembed(h), labels)
        total = main
        metrics = {"ce_loss": main}
        if cfg.moe:
            total = total + MOE_LB_COEF * lb + MOE_Z_COEF * z
            metrics.update(lb_loss=lb, z_loss=z)
        if cfg.mtp_depth:
            mtp = self._mtp_loss(batch["tokens"], labels)
            total = total + MTP_COEF * mtp
            metrics["mtp_loss"] = mtp
        metrics["loss"] = total
        return total, {k: v.detach() for k, v in metrics.items()}

    def _chunked_xent(self, h, labels, chunk: int):
        """Mean cross-entropy over sequence chunks: the logits exist one
        [B,chunk,V] tile at a time (each tile's share weighted chunk/S, as
        the reference sums them)."""
        S = h.shape[1]
        acc = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(S // chunk):
            sl = slice(i * chunk, (i + 1) * chunk)
            acc = acc + _xent(self.unembed(h[:, sl]), labels[:, sl]) \
                * (chunk / S)
        return acc

    def _mtp_loss(self, tokens, labels):
        """The reference's multi-token prediction (depth 1) on the
        embedding stream: the MTP block over ``proj([norm_h(emb(t));
        norm_e(emb(t+1))])`` predicts ``label_{t+1}``."""
        mp = self.mtp
        h = self.embed_tokens(tokens)
        B, S = tokens.shape[:2]
        positions = torch.arange(S - 1, dtype=torch.int32,
                                 device=tokens.device).expand(B, S - 1)
        hh = rmsnorm(mp["norm_h"], h[:, :-1])
        he = rmsnorm(mp["norm_e"], self.embed_tokens(tokens[:, 1:]).to(
            hh.dtype))
        x = torch.cat([hh, he], dim=-1) @ mp["proj"]
        x, _ = self._apply_block(mp["block"], self.sigs[-1], x, positions,
                                 None, "train", None)
        return _xent(self.unembed(x), labels[:, 1:])


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` in float32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0].mean()
