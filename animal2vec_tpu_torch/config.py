"""Configuration of the a2v-large finetune preset: the model and inference
fields (``FinetuneConfig``) and the training recipe (``FinetuneTrainConfig``);
the image serving model (``ImageConfig``); data2vec-2 pretraining
(``PretrainConfig``: the a2v-large recipe, and ``PretrainConfig.vit_b16``);
and a training run (``RunConfig``: the recipe with its data, batching,
validation, checkpoint, logging and device-layout groups,
``RunConfig.finetune_100`` and ``RunConfig.a2v_large_pretrain``), changed
by dotted ``key=value`` overrides (``apply_overrides``).

The JAX package reads a YAML tree (``animal2vec_tpu/config.py``); the port
needs only the fields that the finetuned forward path and long-file
inference read, so it keeps them in one frozen dataclass. The defaults are
the values that ``load_config("animal2vec_tpu/configs/finetune_100.yaml")``
resolves to (``tests/test_torch_modules.py`` compares them field by field).
Smaller models for tests are ``dataclasses.replace(FinetuneConfig(), ...)``.

The encoder's architecture options are the JAX package's: the frontend's
first layer (the parametric sinc, its learnable-kernel mode with
``apply_window_to_root``, or with ``sinc_input`` False a plain conv), its
norm (``sinc_norm`` "layer_norm", "instance" or "pcen") and the
``extractor_mode`` ("layer_norm", or "default": one GroupNorm per channel
on layer 0 only); a LayerNorm before the positional convs
(``conv_pos_pre_ln``); post-LN or pre-LN blocks (``layer_norm_first``)
with or without affine norms (``norm_affine``); ALiBi (``use_alibi_encoder``)
with a learned scale per head or one shared by the heads
(``learned_alibi_scale_per_head``), for all layers or one per layer; and
drop-path rates, ``linspace(start, end, depth)`` over the trunk's blocks
and over the prenet's (``prenet_*_drop_path_rate``). The defaults are the
recipes' values, which the port assumed before it took these options. A
YAML recipe in the JAX package's schema is read by ``recipes.load_config``
(``load_config`` here), which maps, ignores or refuses each of its keys.
Rematerialization (``remat``, ``remat_scope``, ``remat_frontend``,
``remat_decoder``) recomputes what ``torch.utils.checkpoint`` is given at
JAX's boundaries (``models/modules.py``). Every trunk width runs, in every
``matmul_impl``: the blocks take the kernels where JAX takes its Pallas
kernels (every width a multiple of 128) and JAX's XLA route elsewhere
(``models.modules.kernel_widths``).
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

MATMUL_IMPLS = ("bf16", "int8", "int8_attn")  # model.matmul_impl
REMAT_SCOPES = ("mlp", "attn", "block")  # model.remat_scope

MEERKAT_LABELS = (
    "beep", "synch", "sn", "cc", "ld", "oth", "mo", "al", "soc", "agg",
    "eating", "focal",
)


def _check_encoder(cfg) -> None:
    """The fields ``FinetuneConfig`` and ``ImageConfig`` share: the trunk's
    widths and numerics, remat and the extra tokens."""
    _check_trunk(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio, cfg.matmul_impl)
    if cfg.remat_scope not in REMAT_SCOPES:
        raise ValueError(f"remat_scope={cfg.remat_scope!r}: expected one of {REMAT_SCOPES}")
    if cfg.num_extra_tokens < 0:
        raise ValueError(f"num_extra_tokens={cfg.num_extra_tokens} must be >= 0")


def _check_trunk(embed_dim: int, num_heads: int, mlp_ratio: float, matmul_impl: str) -> None:
    if embed_dim % num_heads:
        raise ValueError(f"embed_dim {embed_dim} is not a multiple of num_heads {num_heads}")
    if matmul_impl not in MATMUL_IMPLS:
        raise ValueError(f"matmul_impl={matmul_impl!r}: expected one of {MATMUL_IMPLS}")


@dataclass(frozen=True)
class FinetuneConfig:
    # conv frontend: [(dim, kernel, stride), ...] (task.conv_feature_layers)
    conv_layers: Tuple[Tuple[int, int, int], ...] = (
        (127, 63, 1), (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
        (512, 3, 1), (512, 2, 1), (512, 2, 1),
    )
    sample_rate: int = 8_000
    sinc_norm: str = "layer_norm"  # "layer_norm" | "instance" | "pcen"
    use_pswish: bool = True
    # layer 0: the sinc filterbank (its learnable-kernel mode with
    # apply_window_to_root), or a plain he-normal conv with GELU when
    # sinc_input is False (with apply_window_to_root the parametric sinc, a
    # quirk of the JAX package kept as it is)
    sinc_input: bool = True
    apply_window_to_root: bool = False
    # "layer_norm": a norm after every conv; "default": a GroupNorm with one
    # group per channel after layer 0 only
    extractor_mode: str = "layer_norm"
    # an affine fp32 LayerNorm before the positional convs
    conv_pos_pre_ln: bool = False
    # grouped-conv relative positions (model.modalities.audio.conv_pos_*)
    conv_pos_width: int = 95
    conv_pos_groups: int = 16
    conv_pos_depth: int = 5
    # transformer: prenet_depth prenet blocks, then depth trunk blocks
    prenet_depth: int = 8
    depth: int = 16
    embed_dim: int = 1024
    num_heads: int = 16
    mlp_ratio: float = 4.0
    norm_eps: float = 1e-5
    # pre-LN blocks (the prenet's LayerNorm after its blocks, a final
    # LayerNorm after the trunk), and LayerNorms with or without affine
    layer_norm_first: bool = False
    norm_affine: bool = True
    # a layer's tap: the MLP output, or with end_of_block_targets the
    # block's output (model.end_of_block_targets; finetuning reads it too)
    end_of_block_targets: bool = False
    # drop-path, linspace(start, end, depth) over the trunk's blocks (a
    # finetune run takes finetune.drop_path at both ends) and over the
    # prenet's; the identity in evaluation
    start_drop_path_rate: float = 0.0
    end_drop_path_rate: float = 0.0
    prenet_start_drop_path_rate: float = 0.0
    prenet_end_drop_path_rate: float = 0.0
    # serving-only int8 (model.matmul_impl): "int8" quantizes the MLP only,
    # each post-LN block's fc1/fc2 through the fused int8 block, a pre-LN
    # block's through the int8 fused MLP (the JAX config's comment says
    # qkv/out too, but its AltBlock, modules.py:506-541, keeps attention
    # bf16); "int8_attn" adds the qkv and out projections and, with ALiBi,
    # int8 QK^T and PV inside the attention (without ALiBi the bf16
    # attention takes the int8 projections). Training raises in either.
    matmul_impl: str = "bf16"
    # ALiBi with a learned scale, clipped at 0 and folded into the slopes:
    # one per head, or one shared by the heads; one scale per block (prenet
    # and trunk) with learned_alibi_scale_per_layer. Without ALiBi the
    # attention takes no bias.
    use_alibi_encoder: bool = True
    learned_alibi_scale_per_head: bool = True
    alibi_scale: float = 1.0
    learned_alibi_scale_per_layer: bool = False
    # extra (CLS) tokens prepended to the sequence at the -1 sentinel
    # position (zero ALiBi bias); the first is initialized to 0 with
    # init_extra_token_zero, the others N(0, 1)
    num_extra_tokens: int = 0
    init_extra_token_zero: bool = True
    # training memory (model.remat*): "mlp" recomputes the MLP sub-block
    # (which the fused blocks' backward already does: no change), "attn" also
    # the attention sub-block, "block" whole blocks; remat_frontend the conv
    # frontend, remat_decoder the pretraining decoder
    remat: bool = True
    remat_scope: str = "mlp"
    remat_frontend: bool = False
    remat_decoder: bool = False
    # > 1 splits the trunk by depth over the mesh's "stage" axis as a GPipe
    # of pipeline_microbatches microbatches (0: 2 x stages at most)
    # (model.pipeline_*; distributed.pipeline_parallel sets the stages)
    pipeline_stages: int = 1
    pipeline_microbatches: int = 0
    # head: mean of the last k trunk MLP taps -> linear over the labels
    average_top_k_layers: int = 16
    labels: Tuple[str, ...] = MEERKAT_LABELS
    # long-file inference (task.* and criterion.*)
    normalize: bool = True
    max_sample_size: Optional[int] = 320_000
    metric_threshold: float = 0.175
    sigma_s: float = 0.1
    maxfilt_s: float = 0.1
    max_duration_s: float = 0.5
    lowP: float = 0.125
    iou_threshold: float = 0.0

    def __post_init__(self):
        if self.sinc_norm not in ("layer_norm", "instance", "pcen"):
            raise ValueError(f"sinc_norm={self.sinc_norm!r}: 'layer_norm', 'instance' or 'pcen'")
        if self.extractor_mode not in ("default", "layer_norm"):
            raise ValueError(f"extractor_mode={self.extractor_mode!r}: 'default' or 'layer_norm'")
        _check_encoder(self)
        if not 0 < self.average_top_k_layers <= self.depth:
            raise ValueError(
                f"average_top_k_layers={self.average_top_k_layers} must lie "
                f"in [1, depth={self.depth}]"
            )

    @property
    def segment_length(self) -> float:
        """Window length in seconds that long-file inference cuts
        (``max_sample_size / sample_rate``, 10 s when unset), as the JAX
        ``infer_long_file`` derives it."""
        if self.max_sample_size:
            return self.max_sample_size / self.sample_rate
        return 10.0

    @property
    def n_blocks(self) -> int:
        """Transformer blocks in the model: prenet and trunk."""
        return self.prenet_depth + self.depth

    def criterion(self, threshold: Optional[float] = None) -> dict:
        """The method dict that ``evalx.segmentation.fuse_predict`` reads."""
        return {
            "sigma_s": self.sigma_s,
            "metric_threshold": (
                self.metric_threshold if threshold is None else threshold
            ),
            "maxfilt_s": self.maxfilt_s,
            "max_duration_s": self.max_duration_s,
            "lowP": self.lowP,
            "iou_threshold": self.iou_threshold,
        }


@dataclass(frozen=True)
class ImageConfig:
    """The image modality's serving model (data2vec-2 feature extraction on
    (B, H, W, 3) images): the fields that ``Data2VecMulti.extract_features
    (imgs, "IMAGE")`` reads, with the JAX package's defaults (``ModelConfig``
    for the trunk, ``ImageModalityConfig`` for the patches, ALiBi and the
    prenet, resolved as ``config.resolve`` does: one ALiBi head per trunk
    head). Those make a ViT-B/16: 4 prenet + 8 trunk blocks of 768 with 12
    heads of 64, MLP 3072, 196 patches of 16 x 16 (``tests/test_torch_image_*``
    compare the fields one by one).

    Blocks are post-LN or, with ``layer_norm_first``, pre-LN with a final
    LayerNorm after the trunk. With ``use_alibi_encoder`` every attention
    takes the 2-D ALiBi bias of the patch grid (``alibi_distance``),
    multiplied by a learned scale clipped at 0 (one, or one per head with
    ``learned_alibi_scale_per_head``; one per block with
    ``learned_alibi_scale_per_layer``). Remat as ``FinetuneConfig``'s (the
    image encoder has no conv frontend). Not ported: extra (CLS) tokens
    (they raise: JAX's ``ImageEncoder`` declares no ``extra_tokens``
    parameter, so its image encode fails with them). Pretraining adds the
    decoder (``PretrainConfig``)."""

    input_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    patch_embed_dim: int = 768  # image.embed_dim; != embed_dim adds patch_proj
    fixed_positions: bool = True  # add the 2-D sin-cos table to the patches
    prenet_depth: int = 4
    depth: int = 8
    embed_dim: int = 768
    num_heads: int = 12
    mlp_ratio: float = 4.0
    norm_eps: float = 1e-6
    layer_norm_first: bool = False
    end_of_block_targets: bool = False  # a layer's tap: the MLP output, or the block's
    matmul_impl: str = "bf16"  # as FinetuneConfig.matmul_impl
    use_alibi_encoder: bool = False
    alibi_scale: float = 1.0
    learned_alibi_scale_per_head: bool = False
    learned_alibi_scale_per_layer: bool = False
    alibi_distance: str = "manhattan"  # or "euclidean"
    num_extra_tokens: int = 0
    remat: bool = True
    remat_scope: str = "mlp"
    remat_decoder: bool = False

    def __post_init__(self):
        if self.num_extra_tokens:
            raise NotImplementedError("extra (CLS) tokens of the image modality are not ported "
                                      "(ROADMAP A.7: JAX's ImageEncoder has no extra_tokens)")
        if self.alibi_distance not in ("manhattan", "euclidean"):
            raise ValueError(f"alibi_distance={self.alibi_distance!r}: 'manhattan' or 'euclidean'")
        if self.input_size % self.patch_size:
            raise ValueError(f"input_size {self.input_size} is not a multiple of patch_size "
                             f"{self.patch_size}")
        _check_encoder(self)

    @property
    def grid_size(self) -> int:
        return self.input_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size**2

    @property
    def n_blocks(self) -> int:
        """Transformer blocks in the model: prenet and trunk."""
        return self.prenet_depth + self.depth


@dataclass(frozen=True)
class OptimizationConfig:
    """The optimizer and its schedule (``optimization.*``), with the JAX
    ``OptimizationConfig``'s defaults: Adam with decoupled weight decay,
    global-norm clipping at ``clip_norm`` (0 = none), a linear warmup from
    ``warmup_init_lr`` over ``warmup_updates`` steps, then a cosine decay to
    ``min_lr`` at ``max_update`` (or a constant ``lr``); gradients of
    ``update_freq`` micro-batches per update."""

    lr: float = 1e-4
    max_update: int = 100_000
    update_freq: int = 1
    clip_norm: float = 1.0
    adam_betas: Tuple[float, float] = (0.9, 0.98)
    adam_eps: float = 1e-6
    weight_decay: float = 0.01
    warmup_updates: int = 10_000
    warmup_init_lr: float = 0.0
    min_lr: float = 0.0
    schedule: str = "cosine"
    # the run's other stop conditions (train.loop.RunStopper)
    stop_time_hours: float = 0.0  # 0: no limit
    stop_min_lr: float = -1.0  # stop once the schedule's lr after the warmup falls below

    def __post_init__(self):
        if self.schedule not in ("cosine", "constant"):
            raise ValueError(f"schedule={self.schedule!r}: 'cosine' or 'constant'")


@dataclass(frozen=True)
class FinetuneTrainConfig:
    """The finetune recipe of ``finetune_100.yaml``: the fields that the JAX
    ``finetune_loss``, ``build_finetune_encoder_cfg`` and ``build_optimizer``
    read, with the values ``load_config`` resolves them to. Dropout rates map
    onto the encoder as ``build_finetune_encoder_cfg`` maps them: ``dropout``
    is the attention output dropout, the post-MLP dropout and the prenet
    dropout; ``layerdrop`` holds for the prenet and the trunk."""

    # finetune.*: freeze gate, frontend gradient, masking as regularization
    freeze_finetune_updates: int = 10_000
    # the pretraining linear probe's weights as the head (train/build.py)
    load_pretrain_weights: bool = False
    feature_grad_mult: float = 0.0
    apply_mask: bool = True
    mask_prob: float = 0.825
    mask_length: int = 4
    mask_channel_prob: float = 0.5
    mask_channel_length: int = 64
    zero_mask: bool = False
    mask_noise_std: float = 0.01  # model.modalities.audio.mask_noise_std
    layer_decay: float = 1.0
    # finetune.*: dropouts
    dropout: float = 0.1
    dropout_input: float = 0.0
    activation_dropout: float = 0.1
    attention_dropout: float = 0.2
    final_dropout: float = 0.0
    layerdrop: float = 0.1
    drop_path: float = 0.0
    update_alibi: bool = True
    # train_cli --pretrained <fairseq .pt>: the file's _ema.* weights as the encoder
    load_ema: bool = False
    # finetune.mixup.*
    source_mixup: float = 0.5
    mixup_prob: float = 1.0
    same_mixup: bool = True
    mixing_window_length: float = 0.05
    gain_mode: str = "A_weighting"
    target_mixup: bool = True
    # criterion.*
    use_focal_loss: bool = True
    label_smoothing: float = 0.09
    report_accuracy: bool = True
    # optimization.*
    optimization: OptimizationConfig = OptimizationConfig(
        lr=3e-5, max_update=30_000, update_freq=9, clip_norm=0.0, adam_eps=1e-8,
        weight_decay=0.0, warmup_updates=2_000, warmup_init_lr=1e-10, min_lr=5e-6)

    def __post_init__(self):
        if not self.update_alibi:
            raise NotImplementedError(
                "finetune.update_alibi=False is refused: the JAX package copies it into "
                "audio.learned_alibi_scale, which it reads nowhere, so its ALiBi scale stays "
                "learned; the port refuses the key rather than train a scale that the user "
                "asked to freeze (ROADMAP C)")


@dataclass(frozen=True)
class DecoderConfig:
    """A modality's conv decoder (``DecoderConfig``): ``decoder_layers``
    grouped conv -> LayerNorm -> GELU blocks of ``decoder_dim`` with
    residuals, then one projection to the model width. The defaults are the
    JAX ``DecoderConfig``'s (the image modality's)."""

    decoder_dim: int = 384
    decoder_groups: int = 16
    decoder_kernel: int = 5
    decoder_layers: int = 5
    input_dropout: float = 0.1
    decoder_residual: bool = True
    # the projection head: projection_layers - 1 Linear + exact GELU layers
    # (the first widening by projection_ratio), then the output Linear
    projection_layers: int = 1
    projection_ratio: float = 2.0

    def __post_init__(self):
        if self.decoder_dim % self.decoder_groups:
            raise ValueError(f"decoder_dim {self.decoder_dim} is not a multiple of "
                             f"decoder_groups {self.decoder_groups}")
        if self.projection_layers < 1:
            raise ValueError(f"projection_layers={self.projection_layers} must be >= 1")


@dataclass(frozen=True)
class PretrainConfig:
    """data2vec-2 pretraining (student / EMA-teacher masked regression): the
    encoder ``model`` (a ``FinetuneConfig`` for audio, an ``ImageConfig``
    for images), its modality's decoder and an optional shared decoder, and
    the fields that the JAX ``pretrain_loss``, ``PretrainState`` and
    ``build_optimizer`` read. The defaults are what
    ``load_config("animal2vec_tpu/configs/a2v_large_pretrain.yaml")``
    resolves to (``tests/test_torch_pretrain_ops.py`` compares them field by
    field); ``vit_b16`` is the image cell.

    Targets: the teacher's last k taps (a layer's tap is its MLP output, or
    its block output with the encoder config's ``end_of_block_targets``),
    each normalized in fp32 by the per-layer flags (batch, instance over
    time, layer over channels, in that order), averaged, then normalized by
    ``layer_norm_targets`` and ``instance_norm_targets``
    (``data2vec2.py:494-523``). The regression (weight ``d2v_loss``) is the
    squared error times ``loss_scale`` (None: 1/sqrt(C)), or with
    ``loss_beta`` > 0 the smooth L1 loss, at the masked tokens, one term per
    decoder: the shared one first, then the modality's (``decoder`` may be
    None when ``shared_decoder`` is given). With extra tokens and
    ``cls_loss`` > 0 the output at the last extra token also regresses the
    time-mean target; with ``recon_loss`` > 0 (images) the modality
    decoder's output through ``recon_proj`` regresses the normalized pixel
    patches. ``with_labels`` adds the linear probe on the detached top-k tap
    average (the focal loss; JAX's label-smoothed NLL branch fails on
    either label layout the loader gives, so it is refused, ROADMAP C),
    with ``final_dropout``, the metrics at ``metric_threshold`` and, with
    ``target_mixup``, the mixed labels. ``loss_weights`` ((name, weight)
    pairs, ``criterion.loss_weights``) scales the terms by name before the
    division by the sample size.

    Masking: spans for audio (``mask_dropout`` lowers their count), 2-D
    blocks for images (``mask_prob_adjust`` more block seeds,
    ``inverse_mask`` the complement, both read for images only, as in JAX);
    ``keep_masked_pct`` of the masked tokens stay in the student's keep-set
    (with their unmasked values) and leave the targets; with
    ``encoder_zero_mask`` False the masked steps that the audio positional
    convs see are noise-filled; ``local_grad_mult`` scales the frontend's
    gradient (0 stops it).

    Refused: k > depth (``average_top_k_layers``: the JAX streamed teacher
    sums the taps of every layer but divides by k, so its targets come out
    at depth / k of the stacked average; the port averages the last k
    taps) and the int8 ``matmul_impl`` modes for the student (serving-only);
    the EMA teacher alone may run them (``teacher_matmul_impl``). The
    student's dropouts are the recipe's:
    ``encoder_dropout``, ``attention_dropout``, ``activation_dropout`` and
    ``post_mlp_drop`` in every block, ``prenet_dropout`` before the prenet,
    ``dropout_input`` after it, ``layerdrop`` over the trunk's blocks and
    ``prenet_layerdrop`` over the prenet's, and the model's drop-path
    rates; the teacher runs without them. ``min_target_var`` and
    ``min_pred_var`` are the training loop's collapse floors."""

    # the recipe's encoder; its serving fields (clip length, event
    # threshold) keep the JAX defaults, as the recipe resolves them
    model: Union[FinetuneConfig, ImageConfig] = FinetuneConfig(max_sample_size=None,
                                                               metric_threshold=0.25)
    decoder: Optional[DecoderConfig] = DecoderConfig(768, 16, 7, 4, 0.1)
    shared_decoder: Optional[DecoderConfig] = None
    clone_batch: int = 12
    # masking (model.modalities.<modality>.*): spans for audio, 2-D blocks
    # for images; mask_noise_std is the decoder's mask tokens' noise
    mask_prob: float = 1.5
    mask_length: int = 2
    mask_noise_std: float = 0.01
    mask_dropout: float = 0.0
    keep_masked_pct: float = 0.0
    encoder_zero_mask: bool = True
    local_grad_mult: float = 1.0
    mask_prob_adjust: float = 0.0  # images only
    inverse_mask: bool = False  # images only
    # teacher targets
    average_top_k_layers: int = 16
    instance_norm_target_layer: bool = True
    layer_norm_target_layer: bool = False
    batch_norm_target_layer: bool = False
    instance_norm_targets: bool = False
    layer_norm_targets: bool = False
    ema_decay: float = 0.9997
    ema_end_decay: float = 1.0
    ema_anneal_end_step: int = 300_000
    ema_encoder_only: bool = False
    # dropouts (model.*, modality prenet_dropout)
    encoder_dropout: float = 0.1
    attention_dropout: float = 0.1
    post_mlp_drop: float = 0.1
    prenet_dropout: float = 0.1
    activation_dropout: float = 0.0
    dropout_input: float = 0.0
    layerdrop: float = 0.0
    prenet_layerdrop: float = 0.0
    # model.mixup.* (audio only; source_mixup < 0 turns it off)
    source_mixup: float = 0.5
    mixup_prob: float = 1.0
    same_mixup: bool = True
    mixing_window_length: float = 0.05
    gain_mode: str = "A_weighting"
    target_mixup: bool = False
    # the EMA teacher's numerics (model.teacher_matmul_impl): "" or the
    # student's "bf16", or the int8 serving modes (the teacher's forward
    # only; nothing is differentiated through them)
    teacher_matmul_impl: str = ""
    # losses (model.*): the regression's weight, the CLS term's and the
    # image reconstruction's, the regression's smooth-L1 beta (0: squared
    # error) and scale (None: 1/sqrt(C)); criterion.loss_weights by name
    d2v_loss: float = 1.0
    cls_loss: float = 0.0
    recon_loss: float = 0.0
    loss_beta: float = 0.0
    loss_scale: Optional[float] = None
    loss_weights: Tuple[Tuple[str, float], ...] = ()
    # the linear probe (task.with_labels; criterion.use_focal_loss)
    with_labels: bool = False
    use_focal_loss: bool = True
    final_dropout: float = 0.0
    metric_threshold: float = 0.25
    # the training loop's collapse floors
    min_target_var: float = 0.1
    min_pred_var: float = 0.01
    optimization: OptimizationConfig = OptimizationConfig(max_update=384_230, update_freq=5)

    def __post_init__(self):
        depth = self.model.depth
        if not 0 < self.average_top_k_layers <= depth:
            raise ValueError(
                f"average_top_k_layers={self.average_top_k_layers} must lie in [1, depth={depth}]"
                " (the JAX teacher sums the taps of every layer and divides by k)")
        if self.model.matmul_impl != "bf16":
            raise NotImplementedError("the int8 matmul_impl modes are serving-only")
        if self.teacher_matmul_impl not in ("",) + MATMUL_IMPLS:
            raise ValueError(f"teacher_matmul_impl={self.teacher_matmul_impl!r}: expected '' or "
                             f"one of {MATMUL_IMPLS}")
        m = self.model
        _check_trunk(m.embed_dim, m.num_heads, m.mlp_ratio,
                     self.teacher_matmul_impl or m.matmul_impl)
        if self.clone_batch < 1:
            raise ValueError(f"clone_batch={self.clone_batch} must be >= 1")
        if self.decoder is None and self.shared_decoder is None:
            raise ValueError("pretraining needs a decoder: the modality's, the shared one or both")
        for name in ("keep_masked_pct", "mask_dropout"):
            if not 0.0 <= getattr(self, name) < 1.0:
                raise ValueError(f"{name}={getattr(self, name)} must lie in [0, 1)")
        if self.with_labels and not self.use_focal_loss:
            raise NotImplementedError(
                "the pretraining probe's label-smoothed NLL loss is refused: JAX's branch "
                "(train/pretrain.py:286-293) fails on the (B, T, n) multi-hot labels and on "
                "the (B, T) class labels alike (ROADMAP C)")
        if self.with_labels and self.modality != "AUDIO":
            raise NotImplementedError("the linear probe needs the audio encoder's label set")

    def loss_weight(self, name: str) -> float:
        """``criterion.loss_weights``' weight of the loss term ``name`` (1.0
        where it names none)."""
        return dict(self.loss_weights).get(name, 1.0)

    @property
    def modality(self) -> str:
        return "IMAGE" if isinstance(self.model, ImageConfig) else "AUDIO"

    @classmethod
    def vit_b16(cls, **overrides) -> "PretrainConfig":
        """The image cell: a ViT-B/16 (``ImageConfig`` with the 2-D ALiBi
        bias and one learned scale) with the JAX ``ModelConfig`` /
        ``ImageModalityConfig`` / ``DecoderConfig`` / ``OptimizationConfig``
        defaults, the overrides of JAX's own image pretrain test (ALiBi on,
        the block and prenet dropouts 0, instance-norm target layers,
        ``clone_batch`` 2) but JAX's default ``attention_dropout`` 0.1, and
        k = 8, all the trunk's layers."""
        fields = dict(
            model=ImageConfig(use_alibi_encoder=True), decoder=DecoderConfig(), clone_batch=2,
            mask_prob=0.7, mask_length=5, average_top_k_layers=8, ema_decay=0.999,
            ema_end_decay=0.9999, ema_anneal_end_step=100_000, ema_encoder_only=True,
            encoder_dropout=0.0, attention_dropout=0.1, post_mlp_drop=0.0, prenet_dropout=0.0,
            source_mixup=-1.0, optimization=OptimizationConfig(),
        )
        fields.update(overrides)
        return cls(**fields)


@dataclass(frozen=True)
class CommonConfig:
    """``common.*``: the run's seed (weights from ``seed``, the steps' draws
    from ``seed`` + 23 or + 17, the loader's shuffle from ``seed``), the
    compute dtype, the log interval in steps and the tensorboard directory
    ("" for none); ``profile`` wraps ``train_cli``'s run in a
    ``torch.profiler`` trace to ``tensorboard_logdir or "trace"``, and
    ``suppress_crashes`` logs an exception of the run instead of raising
    it."""

    seed: int = 1
    compute_dtype: str = "float32"  # "bfloat16" | "float32" (JAX's default: float32)
    log_interval: int = 100
    tensorboard_logdir: str = ""
    profile: bool = False
    suppress_crashes: bool = False

    def __post_init__(self):
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype={self.compute_dtype!r}: 'bfloat16' or 'float32'")


@dataclass(frozen=True)
class TaskConfig:
    """``task.*`` that the loader reads beside the model's sample rate,
    normalization, labels and conv stack: the manifest directory (its
    ``<split>.tsv`` files), whether items carry frame labels and how their
    files are named (``label_ext``), the clip length (``max_sample_size``,
    else 10 s) and the items kept."""

    data: str = ""
    with_labels: bool = False
    label_ext: str = "h5"
    do_focal_prediction: bool = True
    min_label_size: int = 0
    max_sample_size: Optional[int] = None
    min_sample_size: int = 1
    verbose_tensorboard_logging: bool = False


@dataclass(frozen=True)
class DatasetConfig:
    """``dataset.*``: batching (B = max_tokens // clip length unless
    ``batch_size``; ``bucket_lengths`` for a fixed set of clip lengths), the
    splits, and when validation runs."""

    max_tokens: int = 408_000
    batch_size: Optional[int] = None
    bucket_lengths: Tuple[int, ...] = ()
    num_workers: int = 8
    train_subset: str = "pretrain"
    valid_subset: str = "valid_0"
    validate_interval_updates: int = 10_000
    validate_after_updates: int = 0
    required_batch_size_multiple: int = 1
    disable_validation: bool = False


@dataclass(frozen=True)
class CheckpointConfig:
    """``checkpoint.*``: where, how often and how many; the metric that
    picks ``best``; ``patience`` validations without a better one stop a
    finetune run (0: never)."""

    save_dir: str = "checkpoints"
    save_interval_updates: int = 10_000
    keep_last: int = 10
    best_checkpoint_metric: str = ""
    maximize_best_checkpoint_metric: bool = True
    patience: int = 0


@dataclass(frozen=True)
class DistributedConfig:
    """``distributed.*``: the device layout (JAX ``DistributedConfig``,
    ``animal2vec_tpu/config.py:126-138``), a ("data", "stage", "model")
    mesh of one process per card (``parallel/mesh.py``): ``data_parallel``
    ranks (-1: every visible card left after the other axes),
    ``pipeline_parallel`` trunk stages, ``model_parallel`` tensor-parallel
    ranks, and ``fsdp`` sharding the blocks' dense kernels over "data"."""

    data_parallel: int = -1
    model_parallel: int = 1
    fsdp: bool = False
    pipeline_parallel: int = 1

    def __post_init__(self):
        if self.data_parallel == 0 or self.data_parallel < -1:
            raise ValueError(f"distributed.data_parallel={self.data_parallel}: -1 (every "
                             "visible card) or a rank count >= 1")
        for name in ("model_parallel", "pipeline_parallel"):
            if getattr(self, name) < 1:
                raise ValueError(f"distributed.{name}={getattr(self, name)}: a rank count >= 1")

    @property
    def sharded(self) -> bool:
        return self.model_parallel > 1 or self.pipeline_parallel > 1 or self.fsdp


@dataclass(frozen=True)
class SegmentationConfig:
    """``criterion.*`` of validation's event scoring beside the model's
    thresholds: whether it runs and how frames fuse into events."""

    segmentation_metrics: bool = False
    method: str = "avg"  # "avg" | "max" | "canny"


@dataclass(frozen=True)
class RunConfig:
    """A training run: a finetune run (``model`` and ``finetune``) or an
    audio pretraining run (``pretrain``, whose ``model`` is the encoder),
    with the groups the loop and the loader read. ``finetune_100`` and
    ``a2v_large_pretrain`` hold what the JAX ``load_config`` resolves those
    YAML files to (``tests/test_torch_train_loop.py`` compares them)."""

    model: Optional[FinetuneConfig] = None
    finetune: Optional[FinetuneTrainConfig] = None
    pretrain: Optional[PretrainConfig] = None
    common: CommonConfig = CommonConfig()
    task: TaskConfig = TaskConfig()
    dataset: DatasetConfig = DatasetConfig()
    checkpoint: CheckpointConfig = CheckpointConfig()
    criterion: SegmentationConfig = SegmentationConfig()
    distributed: DistributedConfig = DistributedConfig()

    def __post_init__(self):
        if (self.finetune is None) == (self.pretrain is None):
            raise ValueError("a run is a finetune run (model and finetune) or a pretrain run "
                             "(pretrain)")
        if self.finetune is not None and self.model is None:
            raise ValueError("a finetune run needs model")
        if self.pretrain is not None:
            if self.model is not None:
                raise ValueError("a pretrain run's encoder is pretrain.model; model must be None")
            if self.pretrain.modality != "AUDIO":
                raise NotImplementedError("the training loop reads audio manifests")
            if self.task.with_labels != self.pretrain.with_labels:
                raise ValueError("task.with_labels (the loader's labels) and "
                                 "pretrain.with_labels (the linear probe) must agree")
        self._check_layout()

    def _check_layout(self) -> None:
        """JAX's config-time check of the pipeline (``config.py:624-631``), and
        the layouts the port leaves out (ROADMAP A.10)."""
        enc, dist = self.encoder, self.distributed
        pp = dist.pipeline_parallel
        if pp > 1 and enc.depth % pp != 0:
            # fail at config time: at apply time the pipelined path would only
            # decline (JAX: with a warning, the plain scan on 1/pp of the slice)
            raise ValueError(f"model.depth={enc.depth} is not divisible by "
                             f"distributed.pipeline_parallel={pp}")
        if enc.pipeline_stages > 1 and enc.pipeline_stages != pp:
            raise ValueError(
                f"model.pipeline_stages={enc.pipeline_stages} but "
                f"distributed.pipeline_parallel={pp}: JAX warns and runs the plain scan there "
                "(models/modules.py:797-824), the port raises")
        teacher = "" if self.pretrain is None else self.pretrain.teacher_matmul_impl
        if dist.sharded and (enc.matmul_impl != "bf16" or teacher not in ("", "bf16")):
            raise NotImplementedError("the int8 matmul_impl modes under a sharded layout are "
                                      "not ported (ROADMAP A.10)")
        if dist.model_parallel > 1 and (enc.layer_norm_first or not enc.use_alibi_encoder):
            raise NotImplementedError("tensor parallelism of pre-LN blocks or without ALiBi is "
                                      "not ported (ROADMAP A.10)")
        mp = dist.model_parallel
        if mp > 1 and (enc.embed_dim % 128 or int(enc.embed_dim * enc.mlp_ratio) % (128 * mp)):
            # the split of #6 keeps its kernels' widths: C and each rank's M
            raise NotImplementedError(
                f"tensor parallelism needs embed_dim and the MLP width / model_parallel in "
                f"multiples of 128 (the split fused block's kernels), got {enc.embed_dim} and "
                f"{int(enc.embed_dim * enc.mlp_ratio)} / {mp}: not ported (ROADMAP A.10)")

    def check_card_dtype(self, device_type: str) -> None:
        """``check_card_dtype`` of this run's encoder, compute dtype, teacher
        and tensor parallelism on a device of ``device_type``."""
        teacher = "" if self.pretrain is None else self.pretrain.teacher_matmul_impl
        check_card_dtype(self.encoder, self.common.compute_dtype, device_type, teacher,
                         self.distributed.model_parallel)

    @property
    def encoder(self) -> FinetuneConfig:
        """The audio encoder's configuration (the conv stack, labels, sample
        rate and normalization that the loader reads)."""
        return self.model if self.pretrain is None else self.pretrain.model

    @property
    def optimization(self) -> OptimizationConfig:
        return (self.finetune or self.pretrain).optimization

    @classmethod
    def finetune_100(cls) -> "RunConfig":
        """``configs/finetune_100.yaml`` (``recipes.load_config``)."""
        return load_config(recipe_path("finetune_100"))

    @classmethod
    def a2v_large_pretrain(cls) -> "RunConfig":
        """``configs/a2v_large_pretrain.yaml`` (``recipes.load_config``)."""
        return load_config(recipe_path("a2v_large_pretrain"))


def check_card_dtype(encoder, compute_dtype: str, device_type: str,
                     teacher_matmul_impl: str = "", model_parallel: int = 1) -> None:
    """Refuse, at build, an fp32 model on a CUDA device whose path runs a
    kernel that has no fp32 instance yet (ROADMAP A.13). The fp32 instances
    are #1-#4 (the ALiBi attention), #6 (the fused post-LN block), #8 (the
    fused pre-LN MLP) and #11 / #11b (the dense-bias attention and its
    backward): audio encoders with or without ALiBi and the image modality,
    post-LN or pre-LN, in bf16 matmuls, training and serving. Still bf16
    only on the card: the int8 modes of the encoder or the teacher (#5 and
    its pass, #7, #9, #10) and tensor parallelism (#6's split, #6s). A pure
    function of the configuration (``encoder`` a ``FinetuneConfig`` or
    ``ImageConfig``), the compute dtype's name and the device type; the CPU
    runs every configuration in fp32 on the plain versions."""
    if compute_dtype != "float32" or device_type != "cuda":
        return
    left_out = []
    if encoder.matmul_impl != "bf16" or teacher_matmul_impl not in ("", "bf16"):
        left_out.append("the int8 modes (#5, #7, #9, #10)")
    if model_parallel > 1:
        left_out.append("tensor parallelism (#6's split)")
    if left_out:
        raise NotImplementedError(
            "fp32 compute on the card runs the bf16-matmul encoders only: no fp32 kernel "
            "instance for " + ", ".join(left_out) + " yet (ROADMAP A.13); compute in bfloat16, "
            "or run on the CPU")


# train_cli --recipe: the short names of two recipe copies
RECIPES = {"finetune_100": RunConfig.finetune_100, "a2v_large_pretrain": RunConfig.a2v_large_pretrain}


def recipe_path(name: str) -> str:
    """The port's copy of the shipped recipe ``name`` (``recipes.RECIPES``)."""
    from animal2vec_tpu_torch.recipes import RECIPES as FILES

    return str(FILES[name])


def load_config(path: Optional[str] = None, overrides: Sequence[str] = ()) -> "RunConfig":
    """The run of a YAML recipe in the JAX package's schema with dotted
    overrides in its key names (``recipes.load_config``)."""
    from animal2vec_tpu_torch.recipes import load_config as load

    return load(path, overrides)


def _coerce(current, value, key: str):
    if current is None or value is None:
        return value
    if isinstance(current, bool):
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        if isinstance(value, (int, float)):
            value = (value,)
        return tuple(tuple(v) if isinstance(v, list) else v for v in value)
    if isinstance(current, str):
        return str(value)
    raise ValueError(f"override {key}: cannot set a {type(current).__name__} from {value!r}")


class _Group(dict):
    """The overrides of one nested group."""


# the optional groups (None until given) and the class an override builds
_OPTIONAL_GROUPS = {"decoder": DecoderConfig, "shared_decoder": DecoderConfig}


def _apply(cfg, changes: _Group, prefix: str):
    names = {f.name for f in dataclasses.fields(cfg)}
    kw = {}
    for name, value in changes.items():
        key = prefix + name
        if name not in names:
            raise ValueError(f"unknown config key {key!r}")
        current = getattr(cfg, name)
        if isinstance(value, _Group) and current is None and name in _OPTIONAL_GROUPS:
            current = _OPTIONAL_GROUPS[name]()  # an absent decoder: from its defaults
        if isinstance(value, _Group):
            if not dataclasses.is_dataclass(current):
                raise ValueError(f"unknown config key {key!r}: not a group")
            kw[name] = _apply(current, value, key + ".")
        else:
            kw[name] = _coerce(current, value, key)
    return dataclasses.replace(cfg, **kw)


def apply_overrides(cfg, overrides: Sequence[str]):
    """``cfg`` (a frozen dataclass) with dotted ``key=value`` overrides: the
    value is a Python literal where it parses as one, else a string, coerced
    to the field's type; each dataclass on the way is rebuilt once with all
    its changes, so it checks them together. Raises ValueError on a
    malformed override or an unknown key."""
    changes = _Group()
    for ov in overrides:
        key, sep, text = ov.partition("=")
        path = key.strip().split(".")
        if not sep or not all(path):
            raise ValueError(f"override must look like key=value, got {ov!r}")
        try:
            value = ast.literal_eval(text)
        except (ValueError, SyntaxError):
            value = text
        node = changes
        for part in path[:-1]:
            node = node.setdefault(part, _Group())
            if not isinstance(node, _Group):
                raise ValueError(f"override {ov!r} descends into a value")
        node[path[-1]] = value
    return _apply(cfg, changes, "")
