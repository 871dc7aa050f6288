"""fairseq-checkpoint converter: the released animal2vec ``.pt`` <-> the
port's state dicts. A copy of ``animal2vec_tpu/train/convert.py`` without
flax and without the JAX package's config.

Import maps the reference's torch state-dict names onto the JAX param tree
(nested dicts of numpy arrays, the layout the JAX package names and
``weights.params_from_jax`` reads), which ``finetune_state_dict`` and
``pretrain_state_dicts`` turn into the port's state dicts. Name sources:

* pretrain model structure: nn/data2vec2.py:199-324 (blocks / norm /
  linear_eval_projection / shared_decoder / recon_proj / _ema),
* audio branch: nn/modalities/audio.py:54-149 (local_encoder.conv_layers.N
  sequentials, project_features.{1,2}, relative_positional_encoder.N.0,
  context_encoder.{blocks,norm}), nn/modalities/base.py:106-150
  (extra_tokens, alibi_scale), nn/modalities/modules.py:137-192
  (decoder.blocks.N.0 / decoder.proj),
* sinc frontend params low_hz_/band_hz_ (+ learnable kernel): nn/sinc.py,
* finetuned wrapper prefixes: ``w2v_encoder.w2v_model.*`` and
  ``w2v_encoder.proj`` (nn/wav2vec2.py:195-212).

Weight layout transforms: torch Linear (out,in) -> JAX (in,out); torch
Conv1d (out, in/groups, k) -> (k, in/groups, out); per-layer block weights
are stacked along a leading depth axis, as the JAX BlockStack scans them.

The architecture comes from a ``config.FinetuneConfig`` (the encoder:
conv stack, prenet and trunk depths, positional convs) and, for a
pretraining checkpoint, the audio decoder's and the shared decoder's layer
counts (each decoder's projection head, ``proj`` or ``proj.{2i}`` between
GELUs, is read whatever its depth). Export (``export_pretrain``) takes a
port state dict back through ``weights.params_to_jax`` and writes the
fairseq names, the shared decoder, the probe and ``recon_proj`` included.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Optional, Tuple

import numpy as np

from animal2vec_tpu_torch.config import FinetuneConfig
from animal2vec_tpu_torch.weights import params_from_jax, params_to_jax

ENCODER_PREFIX = "w2v_encoder.w2v_model."


# ---------------------------------------------------------------------------
# Tolerant torch checkpoint loading (fairseq pickles omegaconf/fairseq objects
# in the 'cfg' entry; we only need the tensors).
# ---------------------------------------------------------------------------


class _Stub:
    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        self.__dict__["_state"] = state

    def __call__(self, *a, **k):
        return self

    def __getattr__(self, name):
        return self


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _Stub


class _TolerantPickleModule:
    """Duck-typed pickle module for ``torch.load(pickle_module=...)``: real
    fairseq checkpoints embed omegaconf/fairseq dataclasses in their
    'cfg'/'args' entries which are unimportable here; unknown classes load as
    inert stubs while every tensor comes through intact."""

    Unpickler = _TolerantUnpickler
    load = staticmethod(pickle.load)
    loads = staticmethod(pickle.loads)
    dump = staticmethod(pickle.dump)
    dumps = staticmethod(pickle.dumps)


def _unreadable(path: str, e: Exception) -> ValueError:
    return ValueError(
        f"checkpoint {path!r} could not be read — likely truncated/corrupt "
        f"(re-download / re-copy it) or an unsupported serialization format: "
        f"{type(e).__name__}: {e}"
    )


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """torch.load with tolerance for missing fairseq/omegaconf classes.

    Truncated/corrupt files raise ``ValueError`` naming the file and the
    failure, instead of surfacing torch's zip/pickle internals
    (``PytorchStreamReader failed reading zip archive`` et al.).
    """
    import torch

    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    except (ImportError, AttributeError, ModuleNotFoundError, pickle.UnpicklingError):
        pass
    except (EOFError, OSError, RuntimeError, KeyError) as e:
        raise _unreadable(path, e) from e
    try:
        return torch.load(path, map_location="cpu", pickle_module=_TolerantPickleModule,
                          weights_only=False)
    except (EOFError, OSError, RuntimeError, KeyError, pickle.UnpicklingError) as e:
        raise _unreadable(path, e) from e


def state_dict_to_numpy(sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in sd.items():
        if k == "_ema" and isinstance(v, dict):
            for ek, ev in v.items():
                out[f"_ema.{ek}"] = _to_np(ev)
        elif hasattr(v, "numpy"):
            out[k] = _to_np(v)
    return out


def _to_np(t) -> np.ndarray:
    return np.ascontiguousarray(t.detach().to("cpu").float().numpy())


# ---------------------------------------------------------------------------
# Trees as flat {path tuple: array} dicts (flax.traverse_util's two helpers)
# ---------------------------------------------------------------------------


def flatten_tree(tree: Dict, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    flat = {}
    for key, value in tree.items():
        path = prefix + (key,)
        if isinstance(value, dict):
            flat.update(flatten_tree(value, path))
        else:
            flat[path] = value
    return flat


def unflatten_tree(flat: Dict[Tuple[str, ...], Any]) -> Dict:
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return tree


# ---------------------------------------------------------------------------
# Name mapping
# ---------------------------------------------------------------------------


def _linear(sd, src, dst, out):
    out[dst + ("kernel",)] = sd[src + ".weight"].T
    if src + ".bias" in sd:
        out[dst + ("bias",)] = sd[src + ".bias"]


def _ln(sd, src, dst, out):
    out[dst + ("scale",)] = sd[src + ".weight"]
    out[dst + ("bias",)] = sd[src + ".bias"]


def _conv1d(sd, src, dst_kernel, out, dst_bias=None):
    w = sd[src + ".weight"]  # (out, in/groups, k)
    out[dst_kernel] = np.transpose(w, (2, 1, 0))
    if dst_bias is not None and src + ".bias" in sd:
        out[dst_bias] = sd[src + ".bias"]


# fairseq AltBlock leaf names by JAX block leaf path
_BLOCK_LEAVES = {
    ("norm1", "scale"): "norm1.weight",
    ("norm1", "bias"): "norm1.bias",
    ("norm2", "scale"): "norm2.weight",
    ("norm2", "bias"): "norm2.bias",
    ("attn", "qkv", "kernel"): "attn.qkv.weight",
    ("attn", "qkv", "bias"): "attn.qkv.bias",
    ("attn", "proj", "kernel"): "attn.proj.weight",
    ("attn", "proj", "bias"): "attn.proj.bias",
    ("mlp", "fc1", "kernel"): "mlp.fc1.weight",
    ("mlp", "fc1", "bias"): "mlp.fc1.bias",
    ("mlp", "fc2", "kernel"): "mlp.fc2.weight",
    ("mlp", "fc2", "bias"): "mlp.fc2.bias",
}


def _map_block_stack(sd: Dict[str, np.ndarray], prefix: str, depth: int,
                     dst: Tuple[str, ...], out: Dict):
    """fairseq AltBlock list -> stacked params. A leaf absent from the
    state dict is skipped: the whole stack (a teacher subset without it), or
    the LayerNorms' of blocks without affine. JAX's converter stops at the
    first absent leaf, so it drops every block of a model without affine
    norms; the port does not copy that."""
    for dst_leaf, src_leaf in _BLOCK_LEAVES.items():
        stack = []
        for i in range(depth):
            key = f"{prefix}.{i}.{src_leaf}"
            if key not in sd:
                break
            w = sd[key]
            if dst_leaf[-1] == "kernel":
                w = w.T
            stack.append(w)
        if len(stack) == depth:
            out[dst + ("block",) + dst_leaf] = np.stack(stack, axis=0)


def _map_decoder1d(sd, prefix: str, dst: Tuple[str, ...], layers: int, out):
    for i in range(layers):
        conv = f"{prefix}.blocks.{i}.0"
        if conv + ".weight" not in sd:
            return
        _conv1d(sd, conv, dst + (f"blocks_{i}", "kernel"), out, dst + (f"blocks_{i}", "bias"))
    if f"{prefix}.proj.weight" in sd:
        _linear(sd, f"{prefix}.proj", dst + ("proj",), out)
    else:
        # multi-layer projection head proj.{i}
        i = 0
        j = 0
        while f"{prefix}.proj.{i}.weight" in sd or f"{prefix}.proj.{i+1}.weight" in sd:
            if f"{prefix}.proj.{i}.weight" in sd:
                _linear(sd, f"{prefix}.proj.{i}", dst + (f"proj_{j}",), out)
                j += 1
            i += 1
            if i > 8:
                break


def map_audio_encoder(
    sd: Dict[str, np.ndarray],
    cfg: FinetuneConfig,
    decoder_layers: Optional[int] = None,
    prefix: str = "modality_encoders.AUDIO",
    dst_root: Tuple[str, ...] = ("audio_encoder",),
) -> Dict[Tuple[str, ...], np.ndarray]:
    """The audio modality encoder's entries, and its decoder's with
    ``decoder_layers``. Layer 0 is read as the sinc filterbank (its
    parametric or learnable-kernel parameters) with ``cfg.sinc_input``, as a
    plain conv otherwise: what JAX's converter maps, and no more (it maps no
    PCEN parameters and no LayerNorm before the positional convs)."""
    out: Dict[Tuple[str, ...], np.ndarray] = {}

    # --- local encoder (ConvFeatureExtractionModel, nn/utils.py:1043-1163)
    le = dst_root + ("local_encoder",)
    for i, (dim, k, stride) in enumerate(cfg.conv_layers):
        base = f"{prefix}.local_encoder.conv_layers.{i}"
        if i == 0 and cfg.sinc_input:
            if f"{base}.0.kernel" in sd:  # learnable-filter mode
                out[le + ("conv_0", "kernel")] = sd[f"{base}.0.kernel"].reshape(dim, k)
            elif f"{base}.0.low_hz_" in sd:
                out[le + ("conv_0", "low_hz")] = sd[f"{base}.0.low_hz_"]
                out[le + ("conv_0", "band_hz")] = sd[f"{base}.0.band_hz_"]
        elif f"{base}.0.weight" in sd:
            out[le + (f"conv_{i}_kernel",)] = np.transpose(sd[f"{base}.0.weight"], (2, 1, 0))
            if f"{base}.0.bias" in sd:
                out[le + (f"conv_{i}_bias",)] = sd[f"{base}.0.bias"]
        # norm: Sequential(conv, dropout, Sequential(T, norm, T), act) -> .2.1
        norm_base = f"{base}.2.1"
        if f"{norm_base}.weight" in sd:
            _ln(sd, norm_base, le + (f"norm_{i}",), out)
        # PSwish activation at .3
        if f"{base}.3.p_swish_alpha" in sd:
            out[le + (f"act_{i}", "p_swish_alpha")] = sd[f"{base}.3.p_swish_alpha"].reshape(-1)
            out[le + (f"act_{i}", "p_swish_beta")] = sd[f"{base}.3.p_swish_beta"].reshape(-1)

    # --- feature projection (audio.py:83-88): Sequential(T, LN, Linear)
    if f"{prefix}.project_features.1.weight" in sd:
        _ln(sd, f"{prefix}.project_features.1", dst_root + ("project_norm",), out)
        _linear(sd, f"{prefix}.project_features.2", dst_root + ("project_linear",), out)

    # --- conv relative positions (audio.py:93-113): Sequential(T, blk*depth, T)
    for i in range(cfg.conv_pos_depth):
        base = f"{prefix}.relative_positional_encoder.{i + 1}.0"
        if base + ".weight" in sd:
            _conv1d(sd, base, dst_root + (f"pos_blocks_{i}", "kernel"), out,
                    dst_root + (f"pos_blocks_{i}", "bias"))

    # --- prenet (BlockEncoder)
    _map_block_stack(sd, f"{prefix}.context_encoder.blocks", cfg.prenet_depth,
                     dst_root + ("context_encoder", "blocks"), out)
    if f"{prefix}.context_encoder.norm.weight" in sd:
        _ln(sd, f"{prefix}.context_encoder.norm", dst_root + ("context_encoder", "norm"), out)

    # --- alibi scale / extra tokens
    if f"{prefix}.alibi_scale" in sd:
        w = sd[f"{prefix}.alibi_scale"]
        if w.ndim == 4:  # upgraded checkpoints add the layer dim (base.py:152-157)
            w = w[None]
        out[dst_root + ("alibi_scale",)] = w
    if f"{prefix}.extra_tokens" in sd:
        out[dst_root + ("extra_tokens",)] = sd[f"{prefix}.extra_tokens"]

    # --- modality decoder
    if decoder_layers is not None:
        _map_decoder1d(sd, f"{prefix}.decoder", dst_root + ("decoder",), decoder_layers, out)
    return out


def _map_model(sd, cfg, decoder_layers) -> Dict[Tuple[str, ...], np.ndarray]:
    out = map_audio_encoder(sd, cfg, decoder_layers)
    _map_block_stack(sd, "blocks", cfg.depth, ("blocks",), out)
    if "norm.weight" in sd:
        _ln(sd, "norm", ("norm",), out)
    return out


def convert_pretrain(sd: Dict[str, np.ndarray], cfg: FinetuneConfig,
                     decoder_layers: Optional[int] = None,
                     shared_decoder_layers: Optional[int] = None
                     ) -> Tuple[Dict, Optional[Dict]]:
    """fairseq data2vec_multi state dict -> (params, ema_params or None), JAX
    trees of numpy arrays; ``shared_decoder_layers`` reads the shared
    decoder (JAX's ``convert.py:288-294``)."""
    out = _map_model(sd, cfg, decoder_layers)
    if "linear_eval_projection.weight" in sd:
        _linear(sd, "linear_eval_projection", ("linear_eval_projection",), out)
    if "recon_proj.weight" in sd:
        _linear(sd, "recon_proj", ("recon_proj",), out)
    if shared_decoder_layers is not None:
        _map_decoder1d(sd, "shared_decoder", ("shared_decoder",), shared_decoder_layers, out)
    params = unflatten_tree(out)

    ema_sd = {k[len("_ema."):]: v for k, v in sd.items() if k.startswith("_ema.")}
    ema_params = None
    if ema_sd:
        eout = _map_model(ema_sd, cfg, decoder_layers)
        # teacher has no frontend/decoders (nn/data2vec2.py:362-384)
        for path in list(eout):
            if path[:2] in (("audio_encoder", "local_encoder"),) or path[1:2] == ("decoder",):
                del eout[path]
        ema_params = unflatten_tree(eout)
    return params, ema_params


def convert_finetune(sd: Dict[str, np.ndarray], cfg: FinetuneConfig) -> Dict:
    """fairseq wav2vec_ccas_finetune state dict -> FinetuneModel params (a
    JAX tree of numpy arrays)."""
    enc_sd = {k[len(ENCODER_PREFIX):]: v for k, v in sd.items() if k.startswith(ENCODER_PREFIX)}
    enc_params, _ = convert_pretrain(enc_sd, cfg)
    flat = flatten_tree({"encoder": enc_params})
    if "w2v_encoder.proj.weight" in sd:
        flat[("proj", "kernel")] = sd["w2v_encoder.proj.weight"].T
        flat[("proj", "bias")] = sd["w2v_encoder.proj.bias"]
    return unflatten_tree(flat)


def verify_tree_shapes(converted: Dict, reference: Dict, strict: bool = False):
    """Compare a converted tree against a freshly-initialized one (nested
    dicts, or flat state dicts); returns (missing, unexpected, mismatched)
    path lists."""
    c = flatten_tree(converted)
    r = flatten_tree(reference)
    missing = sorted(set(r) - set(c))
    unexpected = sorted(set(c) - set(r))
    mismatched = sorted(
        p for p in set(c) & set(r) if tuple(np.shape(c[p])) != tuple(np.shape(r[p]))
    )
    if strict:
        assert not missing and not unexpected and not mismatched, (
            missing, unexpected, mismatched
        )
    return missing, unexpected, mismatched


def finetune_state_dict(sd: Dict[str, np.ndarray], cfg: FinetuneConfig):
    """A fairseq finetune state dict (numpy) -> the port's ``FinetuneModel``
    state dict (fp32 tensors)."""
    return params_from_jax(convert_finetune(sd, cfg))


def pretrain_state_dicts(sd: Dict[str, np.ndarray], cfg: FinetuneConfig,
                         decoder_layers: Optional[int] = None,
                         shared_decoder_layers: Optional[int] = None):
    """A fairseq pretraining state dict (numpy) -> (the port's pretraining
    model state dict, the EMA teacher's dict or None)."""
    params, ema = convert_pretrain(sd, cfg, decoder_layers, shared_decoder_layers)
    return params_from_jax(params), None if ema is None else params_from_jax(ema)


# ---------------------------------------------------------------------------
# Inverse mapping (testing + exporting checkpoints back to fairseq format)
# ---------------------------------------------------------------------------


def export_pretrain(state_dict, cfg: FinetuneConfig) -> Dict[str, np.ndarray]:
    """A port pretraining-model (or finetune encoder) state dict ->
    fairseq-style state dict (the inverse of ``convert_pretrain``, through
    ``params_to_jax``; for interop export and round-trip tests)."""
    flat = flatten_tree(params_to_jax(state_dict))
    sd: Dict[str, np.ndarray] = {}
    pre = "modality_encoders.AUDIO"

    for path, w in flat.items():
        p = tuple(str(x) for x in path)
        if p[0] == "audio_encoder":
            if p[1] == "local_encoder":
                leaf = p[2]
                if leaf == "conv_0":
                    if p[3] == "kernel":
                        dim, k = cfg.conv_layers[0][0], cfg.conv_layers[0][1]
                        sd[f"{pre}.local_encoder.conv_layers.0.0.kernel"] = w.reshape(dim, 1, k)
                    else:
                        sd[f"{pre}.local_encoder.conv_layers.0.0.{p[3]}_"] = w
                elif leaf.startswith("conv_") and leaf.endswith("_kernel"):
                    i = int(leaf.split("_")[1])
                    sd[f"{pre}.local_encoder.conv_layers.{i}.0.weight"] = np.transpose(w, (2, 1, 0))
                elif leaf.startswith("conv_") and leaf.endswith("_bias"):
                    i = int(leaf.split("_")[1])
                    sd[f"{pre}.local_encoder.conv_layers.{i}.0.bias"] = w
                elif leaf.startswith("norm_") and p[3] in ("scale", "bias"):
                    # a norm's affine; PCEN's parameters have no fairseq name
                    # that the import reads (JAX's export writes each of them
                    # over the norm's bias)
                    i = int(leaf.split("_")[1])
                    nm = "weight" if p[3] == "scale" else "bias"
                    sd[f"{pre}.local_encoder.conv_layers.{i}.2.1.{nm}"] = w
                elif leaf.startswith("act_"):
                    i = int(leaf.split("_")[1])
                    sd[f"{pre}.local_encoder.conv_layers.{i}.3.{p[3]}"] = w.reshape(1, -1, 1)
            elif p[1] == "project_norm":
                nm = "weight" if p[2] == "scale" else "bias"
                sd[f"{pre}.project_features.1.{nm}"] = w
            elif p[1] == "project_linear":
                sd[f"{pre}.project_features.2.weight" if p[2] == "kernel"
                   else f"{pre}.project_features.2.bias"] = (w.T if p[2] == "kernel" else w)
            elif p[1].startswith("pos_blocks_"):
                i = int(p[1].split("_")[-1])
                if p[2] == "kernel":
                    sd[f"{pre}.relative_positional_encoder.{i + 1}.0.weight"] = np.transpose(
                        w, (2, 1, 0))
                else:
                    sd[f"{pre}.relative_positional_encoder.{i + 1}.0.bias"] = w
            elif p[1] == "context_encoder" and p[2] == "blocks":
                _export_stack(sd, f"{pre}.context_encoder.blocks", p[4:], w)
            elif p[1] == "context_encoder" and p[2] == "norm":
                nm = "weight" if p[3] == "scale" else "bias"
                sd[f"{pre}.context_encoder.norm.{nm}"] = w
            elif p[1] == "alibi_scale":
                sd[f"{pre}.alibi_scale"] = w
            elif p[1] == "extra_tokens":
                sd[f"{pre}.extra_tokens"] = w
            elif p[1] == "decoder":
                _export_decoder(sd, f"{pre}.decoder", p[2:], w)
        elif p[0] == "blocks":
            _export_stack(sd, "blocks", p[2:], w)
        elif p[0] == "norm":
            sd["norm.weight" if p[1] == "scale" else "norm.bias"] = w
        elif p[0] in ("linear_eval_projection", "recon_proj"):
            sd[f"{p[0]}.weight" if p[1] == "kernel" else f"{p[0]}.bias"] = (
                w.T if p[1] == "kernel" else w)
        elif p[0] == "shared_decoder":
            _export_decoder(sd, "shared_decoder", p[1:], w)
    return sd


def _export_stack(sd, prefix, leaf_path, w):
    src = _BLOCK_LEAVES[tuple(leaf_path)]
    for i in range(w.shape[0]):
        wi = w[i]
        if leaf_path[-1] == "kernel":
            wi = wi.T
        sd[f"{prefix}.{i}.{src}"] = wi


def _export_decoder(sd, prefix, leaf_path, w):
    if leaf_path[0].startswith("blocks_"):
        i = int(leaf_path[0].split("_")[1])
        if leaf_path[1] == "kernel":
            sd[f"{prefix}.blocks.{i}.0.weight"] = np.transpose(w, (2, 1, 0))
        else:
            sd[f"{prefix}.blocks.{i}.0.bias"] = w
    elif leaf_path[0] == "proj":
        sd[f"{prefix}.proj.weight" if leaf_path[1] == "kernel" else f"{prefix}.proj.bias"] = (
            w.T if leaf_path[1] == "kernel" else w
        )
    elif leaf_path[0].startswith("proj_"):
        i = int(leaf_path[0].split("_")[1]) * 2  # GELUs interleave in torch Sequential
        name = f"{prefix}.proj.{i}.weight" if leaf_path[1] == "kernel" else f"{prefix}.proj.{i}.bias"
        sd[name] = w.T if leaf_path[1] == "kernel" else w


def export_finetune(state_dict, cfg: FinetuneConfig) -> Dict[str, np.ndarray]:
    """A port ``FinetuneModel`` state dict -> the fairseq finetune names
    (the encoder under ``w2v_encoder.w2v_model.``, the head as
    ``w2v_encoder.proj``): the inverse of ``convert_finetune``."""
    enc = {k[len("encoder."):]: v for k, v in state_dict.items() if k.startswith("encoder.")}
    sd = {ENCODER_PREFIX + k: v for k, v in export_pretrain(enc, cfg).items()}
    for leaf in ("weight", "bias"):
        sd[f"w2v_encoder.proj.{leaf}"] = _to_np(state_dict[f"proj.{leaf}"])
    return sd
