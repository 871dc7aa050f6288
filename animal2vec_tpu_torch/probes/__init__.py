"""Hopper probes that split the kernels' measured gaps: the counterparts of
the JAX package's TPU tuning probes in ``bench/``, one module per file
there, each run on the card as ``python -m animal2vec_tpu_torch.probes.<name>``
(exit 1 without CUDA; the card's name and power limit first):

  kernels    -- #12a, ``attn_v2``: the ALiBi forward with slope-folded
                positions in four variants (products alone, plus the bias,
                plus a bf16-exp or an fp32-exp online softmax) beside #1
                and SDPA (``csrc/probe_attention.cu``)
  pallas_mm  -- #12b, ``row_gemm``: #6's and #8's GEMM core without its
                epilogue, swept over its row tile, beside cuBLAS and the
                fused GEMM launches (``csrc/probe_gemm.cu``)
  attn_probe -- #12c, ``mma_probe``: repeated products at flash-attention
                tile shapes through wgmma and mma.sync, D 64 against 128
                and 256 (``csrc/probe_mma.cu``)
  kernels2   -- #11 without bias, #1, #12a and SDPA side by side, and a
                matmul chain through cuBLAS and #12b
  timing     -- CUDA-event and profiler times, the card's peaks and bounds

Each kernel's wrapper runs its plain twin (``*_plain``) for a CPU tensor
only, launches its kernel for a CUDA tensor, and counts its launches.
Importing a module builds and runs nothing.
"""
