"""LanguageModel: the dense-attention, SSM, MoE and hybrid stacks of
:mod:`repro.models.model` as an ``nn.Module`` holding its weights.

Every layer is ``ln1 → mixer → ln2 → ffn`` with residuals; the mixer is
GQA attention or Mamba-2 by ``cfg.layer_kind``, and the FFN is the MoE
layer (:func:`repro_torch.models.moe.moe_ffn`, the dispatch policy
``cfg.moe_balance``) where ``cfg.layer_is_moe``, else the dense FFN.  The
layers run as a Python loop over per-layer weights (the reference stacks
its periodic body and scans it; :meth:`LanguageModel.structure` gives that
period, which :func:`repro_torch.models.params.from_reference` needs to
read the reference's stacked tree).  MLA, cross-attention, the audio and
vision frontends, multi-token prediction, ``pad_heads`` and training are
not ported yet (ROADMAP A15) and raise ``NotImplementedError``.

A zero-width FFN (``d_ff = 0``, as mamba2_780m has) is kept: it adds
exact zeros after ``ln2``, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.graph import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ffn, ffn_specs, rmsnorm, rmsnorm_specs
from repro_torch.models.moe import moe_ffn, moe_specs
from repro_torch.models.params import ParamSpec, init_params, map_tree


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP A15)")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not build yet."""
    if cfg.attention == "mla":
        _not_ported("MLA (multi-head latent attention)")
    if cfg.cross_attn_every:
        _not_ported("cross-attention (the vision layers)")
    if cfg.frontend is not None:
        _not_ported(f"the {cfg.frontend} frontend")
    if cfg.mtp_depth:
        _not_ported("multi-token prediction")
    if cfg.pad_heads:
        _not_ported("pad_heads (the padded GQA head layout)")


def block_specs(cfg: ModelConfig, kind: str, is_moe: bool) -> dict:
    block = {
        "ln1": rmsnorm_specs(cfg.d_model),
        "mixer": (attn.gqa_specs(cfg) if kind == "attn"
                  else mb.mamba_specs(cfg)),
        "ln2": rmsnorm_specs(cfg.d_model),
    }
    if is_moe:
        block["moe"] = moe_specs(cfg)
    else:
        block["ffn"] = ffn_specs(cfg.d_model, cfg.d_ff,
                                 activation=cfg.ffn_activation,
                                 dtype=cfg.dtype)
    return block


def model_param_specs(cfg: ModelConfig) -> dict:
    """The spec tree: ``embed``, ``final_norm``, ``layers`` (one block per
    layer) and ``lm_head`` unless the embeddings are tied."""
    check_supported(cfg)
    v, d = cfg.vocab_size, cfg.d_model
    specs = {
        "embed": ParamSpec((v, d), cfg.dtype, "scaled", scale=d ** 0.5),
        "final_norm": rmsnorm_specs(d),
        "layers": [block_specs(cfg, cfg.layer_kind(i), cfg.layer_is_moe(i))
                   for i in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, v), cfg.dtype, "scaled")
    return specs


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: dict entries become
    submodules, tensors become parameters (no gradients: the port serves).
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

    def tree(self) -> dict:
        return {k: (v.tree() if isinstance(v, ParamTree) else v)
                for k, v in {**dict(self.named_children()),
                             **dict(self.named_parameters(
                                 recurse=False))}.items()}


class LanguageModel(nn.Module):
    """``LanguageModel(cfg, seed=0, device="cuda")``: the model with
    weights from :func:`init_params` (seeded, made on the CPU and moved to
    ``device``, so a seed gives the same weights on every device).
    ``device="cuda"`` without a card raises."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
        self.is_moe = [cfg.layer_is_moe(i) for i in range(cfg.num_layers)]
        params = init_params(model_param_specs(cfg),
                             torch.Generator().manual_seed(seed))
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.final_norm = ParamTree(params["final_norm"])
        self.layers = nn.ModuleList(ParamTree(b) for b in params["layers"])
        if "lm_head" in params:
            self.lm_head = nn.Parameter(params["lm_head"],
                                        requires_grad=False)
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
        return tree

    def structure(self) -> tuple[int, int]:
        """``(prefix_len, period)`` of the reference's layer program: the
        smallest prefix + period after which the layers' signatures (mixer
        kind, MoE or not) repeat."""
        L = self.cfg.num_layers
        sigs = list(zip(self.kinds, self.is_moe))
        best, best_cost = (L, 1), L + 1
        for period in range(1, L + 1):
            for prefix in range(L):
                body = sigs[prefix:]
                if len(body) % period:
                    continue
                if prefix + period >= best_cost:
                    break
                if all(body[i] == body[i % period] for i in range(len(body))):
                    best, best_cost = (prefix, period), prefix + period
                    break
        return best

    # ------------------------------------------------------------------
    def new_cache(self, batch: int, max_len: int) -> dict:
        """A zeroed cache on the model's device: one dict per layer (GQA
        ``k``/``v`` [batch,Hkv,max_len,hd]; Mamba ``ssm`` and conv
        windows); every leaf has the batch on axis 0."""
        cfg = self.cfg
        layers = []
        for kind in self.kinds:
            specs = (attn.gqa_cache_specs(cfg, batch, max_len)
                     if kind == "attn" else mb.mamba_cache_specs(cfg, batch))
            layers.append(map_tree(
                lambda _, s: torch.zeros(s.shape, dtype=s.torch_dtype,
                                         device=self.device), specs))
        return {"layers": layers}

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens].to(self.embed.dtype)

    def unembed(self, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return h @ self.embed.T
        return h @ self.lm_head

    def _block(self, i: int, h, positions, cache, mode: str, position):
        """Layer ``i`` -> ``(h, aux)``: ``aux`` is :func:`moe_ffn`'s for an
        MoE layer (its routing included), else None."""
        cfg, p = self.cfg, self.layers[i]
        hn = rmsnorm(p["ln1"], h)
        c = cache["layers"][i] if cache is not None else None
        if self.kinds[i] == "attn":
            if mode == "decode":
                out, _ = attn.gqa_decode(p["mixer"], cfg, hn, position, c)
            else:
                out, _ = attn.gqa_forward(p["mixer"], cfg, hn, positions, c)
        else:
            if mode == "decode":
                out, _ = mb.mamba_decode(p["mixer"], cfg, hn, c)
            else:
                out, _ = mb.mamba_forward(p["mixer"], cfg, hn, c)
        h = h + out
        hn = rmsnorm(p["ln2"], h)
        if not self.is_moe[i]:
            return h + ffn(p["ffn"], hn, activation=cfg.ffn_activation), None
        out, aux = moe_ffn(p["moe"], cfg, hn)
        return h + out, aux

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *, mode: str = "prefill",
                cache: Optional[dict] = None):
        """tokens [B,S] -> (logits [B,S,V], cache).  With a cache (from
        :meth:`new_cache`, capacity >= S) this is the prefill that fills
        it; the cache is updated in place and returned."""
        if mode != "prefill":
            _not_ported(f"mode={mode!r} (training: trainer, optim, loss)")
        h = self.embed_tokens(tokens)
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        for i in range(self.cfg.num_layers):
            h, _ = self._block(i, h, positions, cache, "prefill", None)
        h = rmsnorm(self.final_norm, h)
        return self.unembed(h), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor, position):
        """tokens [B,1]; ``position`` an int (lockstep) or a [B] tensor
        (ragged slots).  Returns (logits [B,1,V], cache updated in
        place)."""
        h = self.embed_tokens(tokens)
        for i in range(self.cfg.num_layers):
            h, _ = self._block(i, h, None, cache, "decode", position)
        h = rmsnorm(self.final_norm, h)
        return self.unembed(h), cache

    def loss(self, *args, **kwargs):
        _not_ported("the training loss (trainer, optim, loss)")
