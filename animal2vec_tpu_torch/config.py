"""Configuration of the a2v-large finetune preset: the model and inference
fields (``FinetuneConfig``) and the training recipe (``FinetuneTrainConfig``).

The JAX package reads a YAML tree (``animal2vec_tpu/config.py``); the port
needs only the fields that the finetuned forward path and long-file
inference read, so it keeps them in one frozen dataclass. The defaults are
the values that ``load_config("animal2vec_tpu/configs/finetune_100.yaml")``
resolves to (``tests/test_torch_modules.py`` compares them field by field).
Smaller models for tests are ``dataclasses.replace(FinetuneConfig(), ...)``.

Only what the port implements is configurable: post-LN AltBlocks with
affine LayerNorms, the ``layer_norm`` extractor mode, ``layer_norm`` or
``instance`` sinc norms, no LayerNorm before the positional convs, and one
learned ALiBi scale per head shared by all layers. The int8 serving modes
take the JAX package's lane-aligned route only (its Pallas kernels, every
width a multiple of 128); at other widths JAX composes int8 in XLA with
other numerics, and the port refuses them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

MATMUL_IMPLS = ("bf16", "int8", "int8_attn")  # model.matmul_impl

MEERKAT_LABELS = (
    "beep", "synch", "sn", "cc", "ld", "oth", "mo", "al", "soc", "agg",
    "eating", "focal",
)


@dataclass(frozen=True)
class FinetuneConfig:
    # conv frontend: [(dim, kernel, stride), ...] (task.conv_feature_layers)
    conv_layers: Tuple[Tuple[int, int, int], ...] = (
        (127, 63, 1), (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
        (512, 3, 1), (512, 2, 1), (512, 2, 1),
    )
    sample_rate: int = 8_000
    sinc_norm: str = "layer_norm"  # "layer_norm" | "instance"
    use_pswish: bool = True
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
    # serving-only int8 (model.matmul_impl): "int8" quantizes the MLP only,
    # each post-LN block's fc1/fc2 through the fused int8 block (the JAX
    # config's comment says qkv/out too, but its AltBlock, modules.py:506-541,
    # keeps attention bf16); "int8_attn" adds the qkv and out projections and
    # int8 QK^T and PV inside the attention. Training raises in either.
    matmul_impl: str = "bf16"
    # learned per-head ALiBi scale, clipped at 0 and folded into the slopes
    alibi_scale: float = 1.0
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
        if self.sinc_norm not in ("layer_norm", "instance"):
            raise ValueError(
                f"sinc_norm={self.sinc_norm!r}: the port implements "
                "'layer_norm' and 'instance'"
            )
        if self.embed_dim % self.num_heads:
            raise ValueError(
                f"embed_dim {self.embed_dim} is not a multiple of "
                f"num_heads {self.num_heads}"
            )
        if self.matmul_impl not in MATMUL_IMPLS:
            raise ValueError(
                f"matmul_impl={self.matmul_impl!r}: expected one of {MATMUL_IMPLS}"
            )
        hidden = int(self.embed_dim * self.mlp_ratio)
        if self.matmul_impl != "bf16" and (self.embed_dim % 128 or hidden % 128):
            raise ValueError(
                f"matmul_impl={self.matmul_impl!r} needs embed_dim and the MLP width "
                f"in multiples of 128 (the int8 kernels' route), got {self.embed_dim} "
                f"and {hidden}"
            )
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
class FinetuneTrainConfig:
    """The finetune recipe of ``finetune_100.yaml``: the fields that the JAX
    ``finetune_loss``, ``build_finetune_encoder_cfg`` and ``build_optimizer``
    read, with the values ``load_config`` resolves them to. Dropout rates map
    onto the encoder as ``build_finetune_encoder_cfg`` maps them: ``dropout``
    is the attention output dropout, the post-MLP dropout and the prenet
    dropout; ``layerdrop`` holds for the prenet and the trunk."""

    # finetune.*: freeze gate, frontend gradient, masking as regularization
    freeze_finetune_updates: int = 10_000
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
    lr: float = 3e-5
    max_update: int = 30_000
    update_freq: int = 9
    clip_norm: float = 0.0
    adam_betas: Tuple[float, float] = (0.9, 0.98)
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    warmup_updates: int = 2_000
    warmup_init_lr: float = 1e-10
    min_lr: float = 5e-6
    schedule: str = "cosine"

    def __post_init__(self):
        if self.drop_path != 0.0:
            raise NotImplementedError("drop-path is not ported (the recipe sets it to 0)")
        if not self.update_alibi:
            raise NotImplementedError("a frozen ALiBi scale is not ported (the recipe learns it)")
        if self.schedule not in ("cosine", "constant"):
            raise ValueError(f"schedule={self.schedule!r}: 'cosine' or 'constant'")
