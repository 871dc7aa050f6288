"""animal2vec_tpu_torch: PyTorch + CUDA port of animal2vec_tpu for NVIDIA Hopper.

The JAX package ``animal2vec_tpu`` is the reference; this package mirrors its
layout and module names and imports nothing of it, nor jax: where it needs
a module of the JAX package that has no jax in it, it keeps its own copy
(``evalx.segmentation`` for ``fuse_predict``). It covers finetuned
inference, the finetune train step, int8 serving, image-modality serving
and data2vec-2 pretraining of both modalities:

  config   -- the a2v-large finetune preset (FinetuneConfig) and its
              training recipe (FinetuneTrainConfig), the image model
              (ImageConfig), pretraining (PretrainConfig, vit_b16), and
              the optimizer settings both recipes hold
              (OptimizationConfig)
  ops      -- numpy/torch helpers and the kernel ops: ALiBi and dense-bias
              flash attention (forward, and the training entries with
              their backward kernels), the fused post-LN MLP block and the
              plain fused MLP, their int8 twins and the int8 dense; dropout
              hashes, masking, mixup, losses, metrics
  csrc     -- the hand-written CUDA kernels (sm_90a); kernels/build.py
              compiles them with nvcc at first use
  models   -- nn.Modules from the sinc frontend and the patch embedding to
              FinetuneModel and Data2VecMulti with its decoders, with
              serving (eval) and training arms
  train    -- optimizer and schedule with optax's semantics, train states
              (with the EMA teacher), finetune and pretraining steps
  weights  -- JAX param trees -> state dict, serving bf16 cast
  evalx    -- event fusing of frame probabilities (fuse_predict)
  data     -- WAV reader/writer
  tools    -- infer_cli (long-file inference), profile_forward,
              profile_train_step
"""
