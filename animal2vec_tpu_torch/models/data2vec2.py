"""The data2vec-2 model: the port of ``animal2vec_tpu/models/data2vec2.py``
(``Data2VecMulti`` with ``encode``, ``decode_d2v`` and
``extract_features``; ``make_targets`` and ``ema_param_label``), for one
modality per model, as the JAX package's ``supported_modality``: the audio
encoder of a ``FinetuneConfig``, or the image encoder of an ``ImageConfig``.
With a ``PretrainConfig`` the model gets its modality's decoder and the
teacher's targets (``train/pretrain.py``).

The audio arm runs post-LN or pre-LN blocks (``layer_norm_first``: the
prenet's LayerNorm after its blocks, and a final LayerNorm after the trunk,
``data2vec2.py:117-120, 368-369``), with the structured ALiBi bias or, with
``use_alibi_encoder`` False, none.

The image arm: patches, the fixed 2-D sin-cos positions, the 2-D ALiBi bias
when ``use_alibi_encoder`` (one dense fp32 (1, H, P, P) bias for every
block, or per row at a student's keep-set), the prenet, the trunk, and with
pre-LN blocks the trunk's final LayerNorm (``data2vec2.py:117-120,
203-213, 247-248, 293-302, 368-369``).

Masking (``encode``): masked time steps are zeroed or, with ``zero_mask``
False, filled with ``mask_noise_std * N(0, 1)``, and a channel mask zeroes
whole feature channels, before the audio relative positions
(``data2vec2.py:250-272``). In finetuning (a (B, T) ``mask``) the masked
sequence runs on; a pretraining student (``mask_info`` with
``remove_masked``) runs the kept tokens only: the unmasked values plus the
relative positions computed on the masked sequence, gathered, and its
attention bias at the kept positions (ALiBi ``positions`` = the keep-set ids
for audio, ``masked_alibi`` for images). Otherwise positions are
batch-uniform (1, T).

The JAX trunk pads the sequence to the TPU kernel's block length
(``data2vec2.py:318-344``). In bf16 and ``int8`` the pad rows change no real
row (they are masked keys, and every other op is per row), so the port does
not pad and the attention kernels mask the ragged tail by bounds. In
``int8_attn`` they do: the per-channel v scales of the int8 attention span
every row of the padded sequence. There the port pads as JAX does (zero
rows at position 0, masked as keys, run through prenet and trunk, cut off
after it), so that its scales are JAX's.

Extra (CLS) tokens of the audio encoder (``num_extra_tokens``,
``data2vec2.py:274-315``) are prepended after the positions, at the -1
sentinel position (zero ALiBi bias) and unmasked as keys; they stay in
``x`` and in every tap, as in JAX, and ``decode_d2v`` drops them.
With per-block ALiBi scales (``learned_alibi_scale_per_layer``) the
prenet takes the first ``prenet_depth`` and the trunk the rest.

Not ported: the shared decoder, the transformer decoder, the
reconstruction head and the linear probe of pretraining with labels; no
recipe uses them, and ``recipes.REFUSED`` refuses them (ROADMAP A.7).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from animal2vec_tpu_torch.config import FinetuneConfig, ImageConfig, PretrainConfig
from animal2vec_tpu_torch.models.audio_encoder import AudioEncoder
from animal2vec_tpu_torch.models.images import ImageEncoder
from animal2vec_tpu_torch.models.modules import (
    AltBlock, BlockStack, Fp32LayerNorm, fp32_instance_norm,
)
from animal2vec_tpu_torch.ops.attention import int8_spans
from animal2vec_tpu_torch.ops.dropout import Rngs, dropout
from animal2vec_tpu_torch.ops.int8_mm import quantize_weight
from animal2vec_tpu_torch.ops.masking import (
    MaskInfo, apply_mask, gather_keep, scatter_with_mask_tokens,
)


class Data2VecMulti(nn.Module):
    """The model of the modality ``cfg`` describes ("AUDIO" for a
    ``FinetuneConfig``, "IMAGE" for an ``ImageConfig``). ``rates`` are the
    training dropouts (all 0 for inference): ``encoder_dropout``,
    ``attention_dropout``, ``activation_dropout`` and ``post_mlp_drop`` for
    every block, ``layerdrop`` (the prenet's too unless ``prenet_layerdrop``
    is given) and ``prenet_dropout``, ``dropout_input`` after the prenet,
    ``local_grad_mult`` for the audio frontend and ``mask_noise_std`` for
    the noise fills; the drop-path rates and the audio blocks' pre-LN and
    norm-affine options come with ``cfg``. ``pretrain`` adds the modality's
    decoder (``audio_encoder.decoder`` or ``image_encoder.decoder``) and
    the teacher's ``average_top_k_layers``. ``cfg.remat`` with
    ``cfg.remat_scope`` reaches every block (``modules.AltBlock``), and
    ``cfg.remat_decoder`` recomputes the decoder in the backward."""

    def __init__(self, cfg: Union[FinetuneConfig, ImageConfig],
                 dtype: torch.dtype = torch.float32,
                 local_grad_mult: float = 1.0, layerdrop: float = 0.0,
                 prenet_dropout: float = 0.0, dropout_input: float = 0.0,
                 mask_noise_std: float = 0.01, pretrain: Optional[PretrainConfig] = None,
                 prenet_layerdrop: Optional[float] = None, **rates: float):
        super().__init__()
        self.cfg, self.dtype, self.pretrain = cfg, dtype, pretrain
        self.mode = "IMAGE" if isinstance(cfg, ImageConfig) else "AUDIO"
        self.pad_trunk = cfg.matmul_impl == "int8_attn" and self.mode == "AUDIO"
        self.dropout_input, self.mask_noise_std = dropout_input, mask_noise_std
        decoder = None if pretrain is None else pretrain.decoder
        rates = dict(rates, remat_scope=cfg.remat_scope if cfg.remat else None)
        block_kw = dict(rates)
        if self.mode == "IMAGE":
            block_kw.update(layer_norm_first=cfg.layer_norm_first,
                            ffn_targets=not cfg.end_of_block_targets)
            self.image_encoder = ImageEncoder(
                cfg, prenet_dropout, layerdrop if prenet_layerdrop is None else prenet_layerdrop,
                decoder, **rates)
            self.norm = Fp32LayerNorm(cfg.embed_dim, cfg.norm_eps) if cfg.layer_norm_first else None
        else:
            block_kw.update(layer_norm_first=cfg.layer_norm_first, norm_affine=cfg.norm_affine,
                            drop_path=(cfg.start_drop_path_rate, cfg.end_drop_path_rate))
            self.audio_encoder = AudioEncoder(
                cfg, local_grad_mult, prenet_dropout,
                layerdrop if prenet_layerdrop is None else prenet_layerdrop, decoder, **rates)
            self.norm = Fp32LayerNorm(cfg.embed_dim, cfg.norm_eps, cfg.norm_affine) \
                if cfg.layer_norm_first else None
        self.blocks = BlockStack(
            cfg.depth, cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio, cfg.norm_eps, layerdrop,
            cfg.matmul_impl, **block_kw,
        )
        # the int8 modes' buffers follow every load of the weights
        self.register_load_state_dict_post_hook(lambda module, _: module.quantize_weights())

    def forward(self, *args, method: str = "extract_features", **kwargs):
        """Run the method named ``method`` (as flax's ``apply(method=...)``),
        so that ``torch.func.functional_call`` can run any of them over
        another set of parameters: the EMA teacher runs ``encode``."""
        return getattr(self, method)(*args, **kwargs)

    @property
    def modality_encoder(self) -> Union[AudioEncoder, ImageEncoder]:
        return self.image_encoder if self.mode == "IMAGE" else self.audio_encoder

    def quantize_weights(self) -> None:
        """Quantize the int8 modes' weights (``cfg.matmul_impl``) of every
        block from the stored ones, into non-persistent buffers; a no-op in
        bf16. Runs after every ``load_state_dict``; call it after changing
        the weights any other way."""
        for mod in self.modules():
            if isinstance(mod, AltBlock):
                mod.quantize_weights()

    def quantized_buffers(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The int8 modes' buffers of every block quantized from ``params``
        (the module's parameter names), as ``quantize_weights`` computes
        them from loaded weights: what ``functional_call`` takes beside
        ``params`` to run this module in its int8 mode over other weights
        (the int8 EMA teacher)."""
        out = {}
        for name, mod in self.named_modules():
            if isinstance(mod, AltBlock) and mod.int8:
                for fc, q in (("fc1", "w1"), ("fc2", "w2")):
                    out[f"{name}.{q}_q"], out[f"{name}.{q}_s"] = quantize_weight(
                        params[f"{name}.mlp.{fc}.weight"])
                if mod.attn.int8:
                    for lin in ("qkv", "proj"):
                        out[f"{name}.attn.{lin}_q"], out[f"{name}.attn.{lin}_s"] = \
                            quantize_weight(params[f"{name}.attn.{lin}.weight"])
        return out

    def local_features(self, source: torch.Tensor) -> torch.Tensor:
        """(B, T_wav) waveforms or (B, H, W, C) images -> (B, T, C) local
        features in the compute dtype."""
        return self.modality_encoder.local_features(source, self.dtype)

    def encode(self, local: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None,
               channel_mask: Optional[torch.Tensor] = None, zero_mask: bool = True,
               rngs: Optional[Rngs] = None, mask_info: Optional[MaskInfo] = None,
               remove_masked: bool = False, reduce_targets: bool = False):
        """Masking, positions, prenet and trunk on (B, T, C) local features;
        returns (x, per-layer taps, padding_mask, layer keeps). ``mask`` (B, T)
        or ``mask_info`` mask in place; with ``mask_info`` and
        ``remove_masked`` only the kept tokens run. ``reduce_targets`` (the
        EMA teacher) returns in place of the taps the fp32 sum of the last k
        taps, each instance-normed (``make_targets``): divide it by k for the
        targets."""
        enc = self.modality_encoder
        image = self.mode == "IMAGE"
        x = enc.fixed_positions(local) if image else local
        if mask_info is not None:
            mask = mask_info.mask
        x_pre = x  # the kept values are the same before and after masking
        if mask is not None:
            x = apply_mask(x, mask.to(x.device), zero_mask, self.mask_noise_std,
                           None if zero_mask else rngs.device)
        if channel_mask is not None:
            x = x * (1 - channel_mask.to(x.device, x.dtype)[:, None, :])
        # relative positions computed on the (masked) full sequence
        x_pos = None if image else enc.relative_positions(x)
        keep_set = mask_info is not None and remove_masked
        if keep_set:
            x = gather_keep(x_pre, mask_info)
            if x_pos is not None:
                x = x + gather_keep(x_pos, mask_info)
            if padding_mask is not None:
                padding_mask = torch.gather(padding_mask, 1, mask_info.ids_keep)
        elif x_pos is not None:
            x = x + x_pos
        n_extra = self.cfg.num_extra_tokens
        if image:
            bias = enc.scaled_alibi(mask_info if keep_set else None)
        elif keep_set:
            positions = mask_info.ids_keep.to(torch.int32)
        else:
            # (1, T): batch-uniform positions (the kernel's uniform case)
            positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None]
        if n_extra:  # the extra tokens at the zero-bias sentinel position
            tok = enc.extra_tokens.to(x.dtype).expand(x.shape[0], n_extra, x.shape[-1])
            x = torch.cat([tok, x], dim=1)
            if padding_mask is not None:
                padding_mask = F.pad(padding_mask.bool(), (n_extra, 0))
            positions = F.pad(positions, (n_extra, 0), value=-1)
        t = x.shape[1]
        run_mask, pad = padding_mask, 0
        if not image:
            if not keep_set and self.pad_trunk:
                pad = int8_spans(t)[1] - t
            if pad:
                x = F.pad(x, (0, 0, 0, pad))
                positions = F.pad(positions, (0, pad))
                if run_mask is None:
                    run_mask = torch.zeros((x.shape[0], t), dtype=torch.bool, device=x.device)
                run_mask = F.pad(run_mask.bool(), (0, pad), value=True)
            bias = enc.alibi_spec(positions, n_extra > 0)
        scales = enc.layer_scales()
        prenet_depth = self.cfg.prenet_depth
        x = enc.prenet(x, run_mask, bias, rngs, None if scales is None else scales[:prenet_depth])
        if self.training and self.dropout_input > 0.0:
            x = dropout(x, self.dropout_input, rngs.device)
        x, taps, keeps = self.blocks(x, run_mask, bias, rngs,
                                     None if scales is None else scales[prenet_depth:])
        if self.norm is not None:
            x = self.norm(x)
        if pad:
            x, taps = x[:, :t], [tap[:, :t] for tap in taps]
        if reduce_targets:
            k = self.pretrain.average_top_k_layers
            taps = sum(fp32_instance_norm(tap.float()) for tap in taps[-k:])
        return x, taps, padding_mask, keeps

    def decode_d2v(self, x: torch.Tensor, mask_info: Optional[MaskInfo] = None,
                   rngs: Optional[Rngs] = None) -> List[torch.Tensor]:
        """The modality decoder on the student output (``data2vec2.py:376-412``):
        input dropout in training, the kept tokens (without the extra
        tokens) scattered back among noise mask tokens, the decoder; returns
        one full-length (B, T, C) prediction per decoder."""
        y = x
        rate = self.pretrain.decoder.input_dropout
        if self.training and rate > 0.0:
            y = dropout(y, rate, rngs.device)
        n_extra = self.cfg.num_extra_tokens
        if mask_info is not None:
            y = scatter_with_mask_tokens(y, mask_info, self.mask_noise_std,
                                         None if rngs is None else rngs.device, n_extra)
        elif n_extra:
            y = y[:, n_extra:]
        decoder = self.modality_encoder.decoder
        if self.cfg.remat_decoder and self.training and torch.is_grad_enabled():
            return [checkpoint(decoder, y, use_reentrant=False, preserve_rng_state=False)]
        return [decoder(y)]

    def extract_features(self, source: torch.Tensor, mode: str = "AUDIO",
                         padding_mask: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None,
                         channel_mask: Optional[torch.Tensor] = None,
                         zero_mask: bool = True, rngs: Optional[Rngs] = None) -> dict:
        """The model's modality ``mode`` ("AUDIO" or "IMAGE", as the JAX
        method takes it) -> {"x", "layer_results" (list of taps),
        "padding_mask", "layer_keeps"}.

        AUDIO: a (B, T_wav) waveform; ``mask`` (B, T_feat) and
        ``channel_mask`` (B, C) are 0/1, 1 = masked. IMAGE (serving): (B, H,
        W, C) images, no masks."""
        if mode.upper() != self.mode:
            raise ValueError(f"this model encodes {self.mode}, not {mode!r}")
        if self.mode == "IMAGE" and (self.training or padding_mask is not None
                                     or mask is not None or channel_mask is not None):
            raise NotImplementedError("image feature extraction is ported for serving only: "
                                      "eval(), no masks (pretraining trains the image model)")
        local = self.local_features(source)
        if padding_mask is not None:
            padding_mask = self.audio_encoder.convert_padding_mask(padding_mask, local.shape[1])
        x, taps, pad, keeps = self.encode(local, padding_mask, mask, channel_mask, zero_mask,
                                          rngs)
        return {"x": x, "layer_results": taps, "padding_mask": pad, "layer_keeps": keeps}


def make_targets(taps: Sequence[torch.Tensor], k: int) -> torch.Tensor:
    """Teacher targets from a list of per-layer taps (``data2vec2.py:494-540``
    with the recipes' flags): the mean of the last k taps, each normalized
    over time in fp32 (``instance_norm_target_layer``; no other per-layer
    norm, and ``finish_targets`` is the identity)."""
    return torch.stack([fp32_instance_norm(tap.float()) for tap in taps[-k:]]).mean(dim=0)


_FRONTEND = ("local_encoder", "project_norm", "project_linear", "decoder", "patch_embed",
             "patch_proj")


def ema_param_label(name: Union[str, Tuple[str, ...]], ema_encoder_only: bool) -> bool:
    """True if the parameter ``name`` (the port's dotted name, or a path)
    belongs to the EMA teacher (``data2vec2.py:543-559``): the trunk blocks
    only with ``ema_encoder_only``, else everything but the frontend and the
    decoder (the model has no shared decoder, ``recon_proj`` or probe)."""
    path = tuple(name.split(".")) if isinstance(name, str) else tuple(name)
    if ema_encoder_only:
        return path[0] == "blocks"
    if path[0] in ("audio_encoder", "image_encoder"):
        return path[1] not in _FRONTEND
    return True
