"""animal2vec_tpu_torch: PyTorch + CUDA port of animal2vec_tpu for NVIDIA Hopper.

The JAX package ``animal2vec_tpu`` is the reference; this package mirrors its
layout and module names and imports nothing of it, nor jax: where it needs
a module of the JAX package that has no jax in it, it keeps its own copy
(``evalx.segmentation`` for ``fuse_predict``). It covers finetuned
inference (slice 1) and the finetune train step (slice 2):

  config   -- the a2v-large finetune preset (FinetuneConfig) and its
              training recipe (FinetuneTrainConfig)
  ops      -- numpy/torch helpers and the kernel ops: ALiBi flash attention
              (forward, and the training entry with its backward kernels)
              and the fused post-LN MLP block; dropout hashes, masking,
              mixup, losses, metrics
  csrc     -- the hand-written CUDA kernels (sm_90a); kernels/build.py
              compiles them with nvcc at first use
  models   -- nn.Modules from the sinc frontend to FinetuneModel, with
              serving (eval) and training arms
  train    -- optimizer and schedule with optax's semantics, train state,
              finetune train and eval steps
  weights  -- JAX param trees -> state dict, serving bf16 cast
  evalx    -- event fusing of frame probabilities (fuse_predict)
  data     -- WAV reader/writer
  tools    -- infer_cli (long-file inference), profile_forward,
              profile_train_step
"""
