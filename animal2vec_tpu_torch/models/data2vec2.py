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

The JAX trunk pads the sequence to the TPU kernel's block length where
the bias is an ``AlibiSpec`` (``data2vec2.py:318-344``). In bf16 and
``int8`` the pad rows change no real row (they are masked keys, and every
other op is per row), so the port does not pad and the attention kernels
mask the ragged tail by bounds. In ``int8_attn`` with ALiBi they do: the
per-channel v scales of the int8 attention span every row of the padded
sequence. There the port pads as JAX does (zero rows at position 0, masked
as keys, run through prenet and trunk, cut off after it), so that its
scales are JAX's. An ALiBi-free ``int8_attn`` trunk runs unpadded, as in
JAX: its int8 projections quantize per row, and the bf16 attention masks
nothing it would not.

Extra (CLS) tokens of the audio encoder (``num_extra_tokens``,
``data2vec2.py:274-315``) are prepended after the positions, at the -1
sentinel position (zero ALiBi bias) and unmasked as keys; they stay in
``x`` and in every tap, as in JAX, and ``decode_d2v`` drops them.
With per-block ALiBi scales (``learned_alibi_scale_per_layer``) the
prenet takes the first ``prenet_depth`` and the trunk the rest.

Pretraining (a ``PretrainConfig``): the modality's decoder and the shared
``Decoder1d`` (``shared_decoder``), each with its projection head;
``decode_d2v`` runs the shared one first (``data2vec2.py:376-412``). With
``with_labels`` the linear probe ``linear_eval_projection`` on the detached
top-k tap average, through the decoders without gradient when masking
removed tokens (``linear_eval``, ``data2vec2.py:414-441``); with
``recon_loss`` the reconstruction head ``recon_proj`` and its normalized
pixel-patch targets (``patchify_targets``). The teacher's per-layer and
final target norms are ``normalize_target_layer`` and ``finish_targets``.
Not ported: the transformer decoder (JAX builds it but ``decode_d2v``
never gives it the keys and values it needs, ROADMAP A.7).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from animal2vec_tpu_torch.config import (
    DecoderConfig, FinetuneConfig, ImageConfig, PretrainConfig,
)
from animal2vec_tpu_torch.models.audio_encoder import AudioEncoder
from animal2vec_tpu_torch.models.images import ImageEncoder, patchify
from animal2vec_tpu_torch.models.modules import (
    AltBlock, BlockStack, Decoder1d, Fp32LayerNorm, fp32_instance_norm,
)
from animal2vec_tpu_torch.ops.attention import int8_spans
from animal2vec_tpu_torch.ops.dropout import Rngs, dropout
from animal2vec_tpu_torch.ops.int8_mm import quantize_weight
from animal2vec_tpu_torch.ops.masking import (
    MaskInfo, apply_mask, gather_keep, scatter_with_mask_tokens,
)
from animal2vec_tpu_torch.parallel.pipeline import Stream


class Data2VecMulti(nn.Module):
    """The model of the modality ``cfg`` describes ("AUDIO" for a
    ``FinetuneConfig``, "IMAGE" for an ``ImageConfig``). ``rates`` are the
    training dropouts (all 0 for inference): ``encoder_dropout``,
    ``attention_dropout``, ``activation_dropout`` and ``post_mlp_drop`` for
    every block, ``layerdrop`` (the prenet's too unless ``prenet_layerdrop``
    is given) and ``prenet_dropout``, ``dropout_input`` after the prenet,
    ``local_grad_mult`` for the frontend (for images only 0 acts: it stops
    the gradient, as in JAX) and ``mask_noise_std`` for the noise fills;
    the drop-path rates and the audio blocks' pre-LN and
    norm-affine options come with ``cfg``. ``pretrain`` adds the modality's
    decoder (``audio_encoder.decoder`` or ``image_encoder.decoder``), the
    shared decoder, the probe and the reconstruction head where it asks for
    them, and the teacher's ``average_top_k_layers`` and target norms.
    ``cfg.remat`` with ``cfg.remat_scope`` reaches every block
    (``modules.AltBlock``), and ``cfg.remat_decoder`` recomputes the
    decoders in the backward."""

    def __init__(self, cfg: Union[FinetuneConfig, ImageConfig],
                 dtype: torch.dtype = torch.float32,
                 local_grad_mult: float = 1.0, layerdrop: float = 0.0,
                 prenet_dropout: float = 0.0, dropout_input: float = 0.0,
                 mask_noise_std: float = 0.01, pretrain: Optional[PretrainConfig] = None,
                 prenet_layerdrop: Optional[float] = None, **rates: float):
        super().__init__()
        self.cfg, self.dtype, self.pretrain = cfg, dtype, pretrain
        self.mode = "IMAGE" if isinstance(cfg, ImageConfig) else "AUDIO"
        self.pad_trunk = (cfg.matmul_impl == "int8_attn" and self.mode == "AUDIO"
                          and cfg.use_alibi_encoder)
        self.dropout_input, self.mask_noise_std = dropout_input, mask_noise_std
        decoder = None if pretrain is None else pretrain.decoder
        rates = dict(rates, remat_scope=cfg.remat_scope if cfg.remat else None)
        block_kw = dict(rates, ffn_targets=not cfg.end_of_block_targets)
        if self.mode == "IMAGE":
            block_kw.update(layer_norm_first=cfg.layer_norm_first)
            self.image_encoder = ImageEncoder(
                cfg, prenet_dropout, layerdrop if prenet_layerdrop is None else prenet_layerdrop,
                decoder, local_grad_mult, **rates)
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
        shared = None if pretrain is None else pretrain.shared_decoder
        if shared is not None:
            self.shared_decoder = Decoder1d(
                cfg.embed_dim, cfg.embed_dim, shared.decoder_dim, shared.decoder_kernel,
                shared.decoder_groups, shared.decoder_layers, shared.decoder_residual,
                shared.projection_layers, shared.projection_ratio)
        if pretrain is not None and pretrain.with_labels:
            self.linear_eval_projection = nn.Linear(cfg.embed_dim, len(cfg.labels))
        if pretrain is not None and pretrain.recon_loss > 0:
            # to the patch's pixels for images, the model width otherwise (as
            # JAX builds it; only the image loss reads it)
            out = cfg.patch_size ** 2 * cfg.in_chans if self.mode == "IMAGE" else cfg.embed_dim
            self.recon_proj = nn.Linear(cfg.embed_dim, out)
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
        them from loaded weights (none for layers on the composed route):
        what ``functional_call`` takes beside ``params`` to run this module
        in its int8 mode over other weights (the int8 EMA teacher)."""
        out = {}
        for name, mod in self.named_modules():
            if isinstance(mod, AltBlock):
                if mod.int8_kernel:
                    for fc, q in (("fc1", "w1"), ("fc2", "w2")):
                        out[f"{name}.{q}_q"], out[f"{name}.{q}_s"] = quantize_weight(
                            params[f"{name}.mlp.{fc}.weight"])
                if mod.attn.int8_kernel:
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
               remove_masked: bool = False, reduce_targets: bool = False,
               top_k: Optional[int] = None):
        """Masking, positions, prenet and trunk on (B, T, C) local features;
        returns (x, per-layer taps, padding_mask, layer keeps, streamed).
        ``mask`` (B, T) or ``mask_info`` mask in place; with ``mask_info``
        and ``remove_masked`` only the kept tokens run. ``streamed`` is, with
        ``reduce_targets`` (the EMA teacher), the fp32 sum of the last k
        taps, each normalized by ``normalize_target_layer`` over the real
        rows (divide it by k and ``finish_targets`` for the targets); with
        ``top_k``, the fp32 mean of the last ``top_k`` kept taps; else None.
        A trunk pipelined over stages returns no taps (None) and the same
        ``streamed``."""
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
        stream = None
        if reduce_targets:
            stream = Stream(self.pretrain.average_top_k_layers,
                            lambda tap: normalize_target_layer(tap[:, :t].float(), self.pretrain))
        elif top_k:
            stream = Stream(top_k, lambda tap: tap[:, :t], mean=True)
        x, taps, keeps, streamed = self.blocks(
            x, run_mask, bias, rngs, None if scales is None else scales[prenet_depth:], stream)
        if self.norm is not None:
            x = self.norm(x)
        if pad:
            x, taps = x[:, :t], [tap[:, :t] for tap in taps]
        return x, taps, padding_mask, keeps, streamed

    def decoders(self) -> List[Tuple[nn.Module, DecoderConfig]]:
        """(decoder, its config) of the shared decoder, then of the
        modality's, where the model has them."""
        out = []
        if hasattr(self, "shared_decoder"):
            out.append((self.shared_decoder, self.pretrain.shared_decoder))
        if hasattr(self.modality_encoder, "decoder"):
            out.append((self.modality_encoder.decoder, self.pretrain.decoder))
        return out

    def decode_d2v(self, x: torch.Tensor, mask_info: Optional[MaskInfo] = None,
                   rngs: Optional[Rngs] = None) -> List[torch.Tensor]:
        """The shared decoder, then the modality's, on the student output
        (``data2vec2.py:376-412``): for each, input dropout in training, the
        kept tokens (without the extra tokens) scattered back among noise
        mask tokens, the decoder; returns one full-length (B, T, C)
        prediction per decoder."""
        n_extra = self.cfg.num_extra_tokens
        outs = []
        for decoder, dcfg in self.decoders():
            y = x
            if self.training and dcfg.input_dropout > 0.0:
                y = dropout(y, dcfg.input_dropout, rngs.device)
            if mask_info is not None:
                y = scatter_with_mask_tokens(y, mask_info, self.mask_noise_std,
                                             None if rngs is None else rngs.device, n_extra)
            elif n_extra:
                y = y[:, n_extra:]
            if self.cfg.remat_decoder and self.training and torch.is_grad_enabled():
                outs.append(checkpoint(decoder, y, use_reentrant=False,
                                       preserve_rng_state=False))
            else:
                outs.append(decoder(y))
        return outs

    def linear_eval(self, mean: torch.Tensor, mask_info: Optional[MaskInfo] = None,
                    rngs: Optional[Rngs] = None) -> torch.Tensor:
        """The linear probe's frame logits (``data2vec2.py:414-441``) from
        ``mean``, the fp32 mean of the last k kept taps (``encode``'s
        ``top_k``): detached, the final LayerNorm of a pre-LN trunk, with
        ``mask_info`` the decoders without gradient (the last one's output:
        the keep-set back at full length), final dropout in training,
        ``linear_eval_projection``."""
        x = mean.detach().to(self.dtype)
        if self.norm is not None:
            x = self.norm(x)
        if mask_info is not None and self.decoders():
            with torch.no_grad():
                x = self.decode_d2v(x, mask_info, rngs)[-1]
        rate = self.pretrain.final_dropout
        if self.training and rate > 0.0:
            x = dropout(x, rate, rngs.device)
        w = self.linear_eval_projection
        return F.linear(x, w.weight.to(x.dtype), w.bias.to(x.dtype))

    def recon_head(self, x: torch.Tensor) -> torch.Tensor:
        """The reconstruction projection (``data2vec2.py:480-482``)."""
        w = self.recon_proj
        return F.linear(x, w.weight.to(x.dtype), w.bias.to(x.dtype))

    def patchify_targets(self, imgs: torch.Tensor) -> torch.Tensor:
        """The reconstruction's targets: (B, H, W, C) images -> (B, P, p^2 C)
        pixel patches, each normalized over its values (``data2vec2.py:
        484-491``)."""
        target = patchify(imgs, self.cfg.patch_size)
        mean = target.mean(dim=-1, keepdim=True)
        var = (target - mean).square().mean(dim=-1, keepdim=True)
        return (target - mean) / torch.sqrt(var + 1e-6)

    def extract_features(self, source: torch.Tensor, mode: str = "AUDIO",
                         padding_mask: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None,
                         channel_mask: Optional[torch.Tensor] = None,
                         zero_mask: bool = True, rngs: Optional[Rngs] = None,
                         top_k: Optional[int] = None) -> dict:
        """The model's modality ``mode`` ("AUDIO" or "IMAGE", as the JAX
        method takes it) -> {"x", "layer_results" (list of taps; None from a
        pipelined trunk), "padding_mask", "layer_keeps", "top_k_mean" (with
        ``top_k``, the fp32 mean of the last ``top_k`` kept taps)}.

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
        x, taps, pad, keeps, mean = self.encode(local, padding_mask, mask, channel_mask,
                                                zero_mask, rngs, top_k=top_k)
        return {"x": x, "layer_results": taps, "padding_mask": pad, "layer_keeps": keeps,
                "top_k_mean": mean}


def _norm_over(x: torch.Tensor, dims) -> torch.Tensor:
    mean = x.mean(dim=dims, keepdim=True)
    var = (x - mean).square().mean(dim=dims, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


def normalize_target_layer(tap: torch.Tensor, cfg: PretrainConfig) -> torch.Tensor:
    """One fp32 (B, T, C) tap under the per-layer target norms
    (``data2vec2.py:494-511``): batch norm (over B and T), instance norm
    (over T), layer norm (over C), each without affine, eps 1e-5, in that
    order."""
    if cfg.batch_norm_target_layer:
        tap = _norm_over(tap, (0, 1))
    if cfg.instance_norm_target_layer:
        tap = fp32_instance_norm(tap)
    if cfg.layer_norm_target_layer:
        tap = _norm_over(tap, -1)
    return tap


def finish_targets(y: torch.Tensor, cfg: PretrainConfig) -> torch.Tensor:
    """The norms after the average (``data2vec2.py:514-523``): layer norm
    over C, then instance norm over T; the identity with neither flag."""
    if cfg.layer_norm_targets:
        y = _norm_over(y, -1)
    if cfg.instance_norm_targets:
        y = fp32_instance_norm(y)
    return y


def make_targets(taps: Sequence[torch.Tensor], k: int,
                 cfg: PretrainConfig = PretrainConfig()) -> torch.Tensor:
    """Teacher targets from a list of per-layer taps (``data2vec2.py:
    526-540``): the mean of the last k taps, each normalized in fp32
    (``normalize_target_layer``), then ``finish_targets``; by default with
    the recipes' flags (instance-normed taps, nothing after)."""
    tl = torch.stack([normalize_target_layer(tap.float(), cfg) for tap in taps[-k:]])
    return finish_targets(tl.mean(dim=0), cfg)


_FRONTEND = ("local_encoder", "project_norm", "project_linear", "decoder", "patch_embed",
             "patch_proj")


def ema_param_label(name: Union[str, Tuple[str, ...]], ema_encoder_only: bool) -> bool:
    """True if the parameter ``name`` (the port's dotted name, or a path)
    belongs to the EMA teacher (``data2vec2.py:543-559``): the trunk blocks
    only with ``ema_encoder_only``, else everything but the frontend, the
    decoders, ``recon_proj`` and the probe."""
    path = tuple(name.split(".")) if isinstance(name, str) else tuple(name)
    if ema_encoder_only:
        return path[0] == "blocks"
    if path[0] in ("shared_decoder", "recon_proj", "linear_eval_projection"):
        return False
    if path[0] in ("audio_encoder", "image_encoder"):
        return path[1] not in _FRONTEND
    return True
