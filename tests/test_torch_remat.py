"""Rematerialization (``model.remat``, ``remat_scope`` mlp|attn|block,
``remat_frontend``, ``remat_decoder``): with every dropout on, a tiny
pretraining step's and a finetune step's loss and gradients under remat
equal those without, bit for bit. The recompute replays the forward's
masks only because each block draws its randomness before the
checkpointed region (``AltBlock.draws``); a draw inside the region would
give the recompute other masks and other gradients (the last test shows
that the comparison sees such a difference). The port against JAX with
remat at rates 0: ``tests/test_torch_pretrain_step.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from animal2vec_tpu_torch.config import FinetuneConfig, FinetuneTrainConfig
from animal2vec_tpu_torch.models.finetune import build_finetune_model, build_pretrain_model
from animal2vec_tpu_torch.ops.dropout import Rngs
from animal2vec_tpu_torch.train.finetune_step import finetune_loss
from animal2vec_tpu_torch.train.pretrain import draw_pretrain_mask, pretrain_loss
from animal2vec_tpu_torch.train.state import ema_subset

from tests.test_torch_model import TINY, TINY_LAYERS
from tests.test_torch_pretrain_step import _port_cfg

VARIANTS = {
    "mlp": dict(remat=True, remat_scope="mlp"),
    "attn": dict(remat=True, remat_scope="attn"),
    "block": dict(remat=True, remat_scope="block"),
    "frontend+decoder": dict(remat=False, remat_frontend=True, remat_decoder=True),
}
OFF = dict(remat=False)
RATES = dict(encoder_dropout=0.1, attention_dropout=0.2, post_mlp_drop=0.1, prenet_dropout=0.1,
             mask_noise_std=0.01)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pretrain_grads(modality, remat, layer_norm_first=False):
    cfg = _port_cfg(modality)
    model_cfg = dataclasses.replace(cfg.model, **remat)
    if modality == "IMAGE":
        model_cfg = dataclasses.replace(model_cfg, layer_norm_first=layer_norm_first)
    decoder = dataclasses.replace(cfg.decoder, input_dropout=0.1)
    cfg = dataclasses.replace(cfg, model=model_cfg, decoder=decoder,
                              source_mixup=0.5 if modality == "AUDIO" else -1.0, **RATES)
    model = build_pretrain_model(cfg, seed=3, device="cpu")
    ema = ema_subset(model, cfg.ema_encoder_only)
    shape = (2, 800) if modality == "AUDIO" else (2, 32, 32, 3)
    src = torch.from_numpy(np.random.default_rng(4).normal(size=shape).astype(np.float32))
    masks = {}

    def draw(rows, t, rngs):
        if (rows, t) not in masks:
            masks[rows, t] = draw_pretrain_mask(cfg, rows, t, Rngs.from_seed(9, "cpu"))
        return masks[rows, t]

    loss, _ = pretrain_loss(model, ema, {"source": src}, Rngs.from_seed(5, "cpu"), cfg, True,
                            draw)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                           if p.grad is not None}


# the encoder options with their regularizers: variant P (pre-LN blocks
# without affine, PCEN, the windowed learnable sinc, one ALiBi scale for the
# heads, the fused MLP's activation dropout) and N (no ALiBi, a plain first
# conv, the "default" extractor mode), both with drop-path on every block
OPTIONS = {
    "P": dict(sinc_norm="pcen", apply_window_to_root=True, conv_pos_pre_ln=True,
              learned_alibi_scale_per_head=False, layer_norm_first=True, norm_affine=False,
              prenet_start_drop_path_rate=0.2, prenet_end_drop_path_rate=0.3),
    "N": dict(use_alibi_encoder=False, sinc_input=False, extractor_mode="default"),
}


def _finetune_grads(remat, options=None):
    cfg = dataclasses.replace(FinetuneConfig(conv_layers=TINY_LAYERS, average_top_k_layers=3,
                                             labels=("a", "b", "c", "d"), **TINY), **remat,
                              **OPTIONS.get(options, {}))
    train = dataclasses.replace(FinetuneTrainConfig(), freeze_finetune_updates=0,
                                feature_grad_mult=1.0, mask_channel_length=4, layerdrop=0.2,
                                drop_path=0.3 if options else 0.0)
    model = build_finetune_model(cfg, seed=3, device="cpu", train=train)
    rng = np.random.default_rng(6)
    batch = {"source": torch.from_numpy(rng.normal(size=(2, 800)).astype(np.float32)),
             "target": torch.from_numpy((rng.random((2, 200, 4)) < 0.1).astype(np.float32))}
    loss, _ = finetune_loss(model, batch, Rngs.from_seed(7, "cpu"), 0, train)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                           if p.grad is not None}


def _assert_same(got, want):
    (loss, grads), (loss0, grads0) = got, want
    assert torch.equal(loss, loss0)
    assert grads.keys() == grads0.keys() and grads
    for n in grads0:
        assert torch.equal(grads[n], grads0[n]), n


@pytest.fixture(scope="module")
def references():
    """Remat off: the audio and image pretraining gradients (post-LN and
    pre-LN) and the finetune gradients."""
    return {"AUDIO": _pretrain_grads("AUDIO", OFF), "IMAGE": _pretrain_grads("IMAGE", OFF),
            "IMAGE pre-LN": _pretrain_grads("IMAGE", OFF, layer_norm_first=True),
            "finetune": _finetune_grads(OFF),
            **{f"finetune {v}": _finetune_grads(OFF, v) for v in OPTIONS}}


@pytest.mark.parametrize("variant", VARIANTS)
def test_audio_pretrain_remat_is_bit_exact(variant, references):
    _assert_same(_pretrain_grads("AUDIO", VARIANTS[variant]), references["AUDIO"])


@pytest.mark.parametrize("variant", ["attn", "block", "frontend+decoder"])
@pytest.mark.parametrize("pre_ln", [False, True])
def test_image_pretrain_remat_is_bit_exact(variant, pre_ln, references):
    """The dense-bias attention with its hash dropout, and the pre-LN
    block's residual-branch mask, under remat."""
    remat = {k: v for k, v in VARIANTS[variant].items() if k != "remat_frontend"}
    _assert_same(_pretrain_grads("IMAGE", remat, pre_ln),
                 references["IMAGE pre-LN" if pre_ln else "IMAGE"])


@pytest.mark.parametrize("variant", VARIANTS)
def test_finetune_remat_is_bit_exact(variant, references):
    _assert_same(_finetune_grads(VARIANTS[variant]), references["finetune"])


@pytest.mark.parametrize("variant", ["attn", "block"])
@pytest.mark.parametrize("options", sorted(OPTIONS))
def test_encoder_options_remat_is_bit_exact(variant, options, references):
    """Drop-path's per-sample draws and the pre-LN fused MLP's two hash
    seeds are drawn before the checkpointed region too: bit for bit."""
    loss, grads = _finetune_grads(VARIANTS[variant], options)
    _assert_same((loss, grads), references[f"finetune {options}"])
    assert not torch.equal(loss, references["finetune"][0])


def test_a_draw_inside_the_region_would_differ(references, monkeypatch):
    """The comparison sees the generator trap: a block that draws its masks
    where it uses them, inside the checkpointed region, matches the
    reference without remat, but under "block" remat the recompute draws
    other masks and the gradients differ."""
    from animal2vec_tpu_torch.models import modules

    real = modules.AltBlock._body

    def body_that_draws(self, x, padding_mask, bias, rngs):  # draws in the region
        return real(self, x, padding_mask, bias, self.draws(x, rngs))

    def forward(self, x, padding_mask, bias, rngs=None):
        if self._remat("block"):
            return modules.checkpoint(self._body, x, padding_mask, bias, rngs,
                                      use_reentrant=False, preserve_rng_state=False)
        return self._body(x, padding_mask, bias, rngs)

    monkeypatch.setattr(modules.AltBlock, "_body", body_that_draws)
    monkeypatch.setattr(modules.AltBlock, "forward", forward)
    _assert_same(_pretrain_grads("AUDIO", OFF), references["AUDIO"])
    loss, grads = _pretrain_grads("AUDIO", VARIANTS["block"])
    loss0, grads0 = references["AUDIO"]
    assert torch.equal(loss, loss0)  # the forward drew as before
    assert any(not torch.equal(grads[n], grads0[n]) for n in grads0)
