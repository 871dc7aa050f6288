"""The C++ batch audio loader (``runtime/native.py``)."""

from animal2vec_tpu_torch.runtime.native import (
    available as native_available,
    decode_batch,
    ensure_built,
    wav_info_native,
)
