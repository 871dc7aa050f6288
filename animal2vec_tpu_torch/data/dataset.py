"""Host input pipeline: manifest -> decoded, normalized, frame-labeled,
fixed-shape batches of torch tensors.

The port of ``animal2vec_tpu/data/dataset.py``'s ``AudioLabelDataset``,
``pad_or_crop`` and ``BatchLoader``: the same items, crops, padding,
normalization, frame targets, length buckets, seeded epoch shuffle,
leading ``accum`` axis for training, ``n_valid`` of the last eval group,
checkpointable (epoch, position), host sharding and thread prefetch, so
one directory gives the same batches bit for bit (``tests/test_torch_data.py``,
``tests/test_torch_distributed.py``). Batches leave as torch tensors
(``id``, ``source``, ``valid_len``, ``target``, ``padding_mask``,
``n_valid`` as the JAX batch has them), in pinned memory with
``pin_memory``.

* ``use_native`` (the default, as in JAX) decodes each group with the C++
  batch loader (``runtime.native.decode_batch``): its own seeded crop
  offsets and its normalization (a float64 mean and variance); without it
  each item is decoded in Python and cropped from
  ``np.random.default_rng(group seed)``. The two paths crop training clips
  at different offsets, so the port takes JAX's choice at each call site.
  The library is built at construction; a failed build raises.

* Every batch is (B, T) with B = max_tokens // T (the reference's token
  budget at one shape); ``bucket_lengths`` gives a small fixed set of clip
  lengths, each with its batch size scaled to the same budget.
* Labels are rasterized at the conv feature rate (``ops.frames``).
* Source and target crops are taken at the same relative position.
* Host sharding: a data-parallel rank is a JAX host (``host_index`` =
  rank, ``host_count`` = world size). A rank reads every ``host_count``-th
  item of the epoch's order from its ``host_index`` and groups them into
  its own batches of B = max_tokens // T items, so the global batch is
  world x B ("per replica", as the recipes and the reference's DDP have
  it). Evaluation keeps ``drop_last=False`` and ``n_valid``: ranks may hold
  unequal counts of items, and none.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from animal2vec_tpu_torch.data.labels import audio_path_to_label_path, read_label_file
from animal2vec_tpu_torch.data.manifest import read_manifest
from animal2vec_tpu_torch.data.wavio import read_wav
from animal2vec_tpu_torch.ops.audio import layer_norm_1d
from animal2vec_tpu_torch.ops.conv_arith import label_frame_length
from animal2vec_tpu_torch.ops.frames import frame_targets
from animal2vec_tpu_torch.runtime import native


class AudioLabelDataset:
    """Manifest-backed raw-audio (+ frame-label) dataset."""

    def __init__(
        self,
        manifest_path: str,
        sample_rate: int = 8_000,
        max_sample_size: Optional[int] = None,
        min_sample_size: int = 1,
        normalize: bool = True,
        return_labels: bool = False,
        unique_labels: Optional[Sequence[str]] = None,
        use_focal_loss: bool = True,
        do_focal_prediction: bool = True,
        min_label_size: int = 0,
        conv_layers: Optional[Sequence[Tuple[int, int, int]]] = None,
        label_ext: str = "h5",
    ):
        self.sample_rate = sample_rate
        self.normalize = normalize
        self.return_labels = return_labels
        self.unique_labels = list(unique_labels) if unique_labels else []
        self.use_focal_loss = use_focal_loss
        self.do_focal_prediction = do_focal_prediction
        self.conv_layers = list(conv_layers) if conv_layers else None
        self.max_sample_size = max_sample_size
        self.label_ext = label_ext

        root, entries = read_manifest(manifest_path)
        self.root = root
        self.names: List[str] = []
        sizes: List[int] = []
        skipped = 0
        for rel, frames in entries:
            if frames < min_sample_size:
                skipped += 1
                continue
            if return_labels and min_label_size > 0:
                try:
                    lp = audio_path_to_label_path(
                        os.path.join(root, rel), lblext=label_ext
                    )
                    if not os.path.isfile(lp) or os.path.getsize(lp) <= min_label_size:
                        skipped += 1
                        continue
                except ValueError:
                    skipped += 1
                    continue
            self.names.append(rel)
            sizes.append(frames)
        self.sizes = np.asarray(sizes, dtype=np.int64)
        self.skipped = skipped

    def __len__(self) -> int:
        return len(self.names)

    def targets_for(self, index: int, wav_len: Optional[int] = None) -> np.ndarray:
        """Frame targets from the label file alone (wav length from the
        manifest unless given)."""
        wav_len = wav_len if wav_len is not None else int(self.sizes[index])
        lp = audio_path_to_label_path(
            os.path.join(self.root, self.names[index]), lblext=self.label_ext
        )
        lbl = read_label_file(lp)
        return frame_targets(
            wav_len=wav_len,
            num_classes=len(self.unique_labels),
            starts=lbl.get("start_frame_lbl", []),
            ends=lbl.get("end_frame_lbl", []),
            cats=lbl.get("lbl_cat", []),
            conv_layers=self.conv_layers,
            focal=lbl.get("foc", []),
            multilabel=self.use_focal_loss,
            do_focal_prediction=self.do_focal_prediction
            and bool(self.unique_labels)
            and self.unique_labels[-1].lower() == "focal",
        )

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rel = self.names[index]
        wav, sr = read_wav(os.path.join(self.root, rel))
        if wav.ndim > 1:
            wav = wav[:, 0]
        assert sr == self.sample_rate, (
            f"{rel}: sample rate {sr} != configured {self.sample_rate}; "
            "resample offline with tools/prepare_data_cli.py"
        )
        if self.normalize:
            wav = layer_norm_1d(wav)
        item: Dict[str, np.ndarray] = {"id": np.int64(index), "source": wav.astype(np.float32)}
        if self.return_labels:
            item["target"] = self.targets_for(index, len(wav))
        return item


def pad_or_crop(
    wav: np.ndarray,
    target_len: int,
    rng: np.random.Generator,
    train: bool,
) -> Tuple[np.ndarray, int, int]:
    """Returns (clip, crop_start, valid_len). Random crop during training,
    center crop otherwise; right-pad with zeros when short
    (RawAudioDataset crop/pad semantics consumed at nn/audio_tasks.py:388-431)."""
    n = len(wav)
    if n == target_len:
        return wav, 0, n
    if n > target_len:
        start = int(rng.integers(0, n - target_len + 1)) if train else (n - target_len) // 2
        return wav[start: start + target_len], start, target_len
    out = np.zeros(target_len, dtype=wav.dtype)
    out[:n] = wav
    return out, 0, n


class BatchLoader:
    """Fixed-shape epoch iterator with shuffling, grad-accum stacking and
    thread prefetch, yielding dicts of torch tensors."""

    def __init__(
        self,
        dataset: AudioLabelDataset,
        target_len: int,
        batch_size: Optional[int] = None,
        max_tokens: Optional[int] = None,
        accum: int = 1,
        shuffle: bool = True,
        seed: int = 1,
        drop_last: bool = True,
        num_workers: int = 4,
        host_index: int = 0,
        host_count: int = 1,
        train: bool = True,
        use_native: bool = True,
        bucket_lengths: Optional[Sequence[int]] = None,
        batch_multiple: int = 1,
        pin_memory: bool = False,
    ):
        assert batch_size or max_tokens
        self.dataset = dataset
        self.target_len = target_len
        self.batch_size = batch_size or max(1, max_tokens // target_len)
        # Static-shape length bucketing: a small fixed set of clip lengths
        # with the per-bucket batch size scaled to keep the token budget
        # constant. Items go to the smallest bucket >= their length (longer
        # items crop to the top bucket, as without buckets). Eval uses the
        # same buckets (short clips are not padded to target_len; per-bucket
        # tail groups pad by repeating items and report n_valid).
        self.buckets: Optional[List[int]] = None
        if bucket_lengths:
            bl = sorted({min(int(b), target_len) for b in bucket_lengths} | {target_len})
            self.buckets = bl
            budget = max_tokens if max_tokens else self.batch_size * target_len
            # round each bucket's batch down to batch_multiple
            m = max(1, batch_multiple)
            self._bucket_bs = [max(m, (budget // b) // m * m) for b in bl]
            self._item_bucket = np.searchsorted(
                np.asarray(bl), dataset.sizes, side="left"
            ).clip(0, len(bl) - 1)
        self.accum = max(1, accum)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.host_index = host_index
        self.host_count = host_count
        self.train = train
        self.pin_memory = pin_memory
        self.use_native = use_native
        if use_native:
            native.ensure_built()  # raises where the library cannot be built
        self.epoch = 0
        # groups already consumed within the current epoch — advances as
        # batches are yielded so a checkpointed (epoch, position) resumes
        # the exact remaining batch sequence
        self.position = 0
        if dataset.return_labels:
            self.target_frames = label_frame_length(target_len, dataset.conv_layers)
        self._frames_cache: Dict[int, int] = {}

    def _frames_for(self, length: int) -> int:
        """label frames for a clip length (cached per bucket length)."""
        if length not in self._frames_cache:
            self._frames_cache[length] = label_frame_length(
                length, self.dataset.conv_layers
            )
        return self._frames_cache[length]

    def set_epoch(self, epoch: int):
        if epoch != self.epoch:
            self.position = 0
        self.epoch = epoch

    def state_dict(self) -> Dict:
        return {"epoch": self.epoch, "position": self.position}

    def load_state_dict(self, d: Dict):
        self.epoch = int(d.get("epoch", 0))
        self.position = int(d.get("position", 0))

    def __len__(self) -> int:
        if self.buckets is not None:
            n = 0
            counts = np.bincount(
                self._item_bucket[np.arange(len(self.dataset))[self.host_index::self.host_count]],
                minlength=len(self.buckets))
            for bi, cnt in enumerate(counts):
                group = self._bucket_bs[bi] * self.accum
                n += cnt // group
                if not self.drop_last and cnt % group:
                    n += 1
            return int(n)
        n_items = len(self.dataset) // self.host_count
        group = self.batch_size * self.accum
        n = n_items // group
        if not self.drop_last and n_items % group:
            n += 1
        return n

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        return order[self.host_index::self.host_count]

    def _make_item(
        self, idx: int, rng: np.random.Generator, length: Optional[int] = None
    ) -> Dict[str, np.ndarray]:
        length = length or self.target_len
        item = self.dataset[int(idx)]
        wav = item["source"]
        clip, start, valid = pad_or_crop(wav, length, rng, self.train)
        out = {"id": item["id"], "source": clip, "valid_len": np.int64(valid)}
        if "target" in item:
            out["target"] = self._crop_target(item["target"], len(wav), start, length)
        return out

    def _crop_target(
        self, tgt: np.ndarray, wav_len: int, start: int, length: Optional[int] = None
    ) -> np.ndarray:
        """Crop the feature-rate target aligned with the waveform crop."""
        tf = self._frames_for(length or self.target_len)
        scale = len(tgt) / max(1, wav_len)
        t_start = int(round(start * scale))
        if len(tgt) >= t_start + tf:
            return tgt[t_start: t_start + tf]
        padded = np.zeros((tf,) + tgt.shape[1:], dtype=tgt.dtype)
        padded[: len(tgt) - t_start] = tgt[t_start:]
        return padded

    def _make_group_native(
        self, idxs, seed: int, length: Optional[int] = None
    ) -> List[Dict[str, np.ndarray]]:
        """A group decoded by the C++ loader, with the frame targets cropped
        at the offsets it chose."""
        length = length or self.target_len
        ds = self.dataset
        paths = [os.path.join(ds.root, ds.names[int(i)]) for i in idxs]
        out, valid, starts = native.decode_batch(
            paths, length, normalize=ds.normalize, train=self.train, seed=seed,
            expected_sr=ds.sample_rate)
        items = []
        for j, i in enumerate(idxs):
            item = {"id": np.int64(i), "source": out[j], "valid_len": np.int64(valid[j])}
            if ds.return_labels:
                wav_len = int(ds.sizes[int(i)])
                item["target"] = self._crop_target(
                    ds.targets_for(int(i), wav_len), wav_len, int(starts[j]), length)
            items.append(item)
        return items

    def _collate(
        self, items: List[Dict[str, np.ndarray]], length: Optional[int] = None
    ) -> Dict[str, np.ndarray]:
        length = length or self.target_len
        batch = {
            "id": np.stack([i["id"] for i in items]),
            "source": np.stack([i["source"] for i in items]),
        }
        valid = np.stack([i["valid_len"] for i in items])
        if (valid < length).any():
            idx = np.arange(length)[None, :]
            batch["padding_mask"] = idx >= valid[:, None]
        if "target" in items[0]:
            batch["target"] = np.stack([i["target"] for i in items])
        return batch

    def _group_seed(self, pos: int) -> int:
        """Crop/augment seed for epoch-group ``pos`` — a pure function of
        (seed, epoch, position) so a mid-epoch resume regenerates identical
        crops for the remaining groups."""
        return int(
            np.random.default_rng((self.seed, self.epoch, pos)).integers(0, 2**31)
        )

    def _epoch_plan(self) -> List[Tuple[np.ndarray, int, int]]:
        """Deterministic (idxs, clip_len, batch_size) groups for this epoch.

        Without buckets: contiguous groups of the shuffled host order at the
        fixed target length. With buckets: per-bucket grouping at that
        bucket's length/batch size, group order mixed by the epoch seed so
        the lengths are spread through the epoch rather than sorted."""
        order = self._order()
        if self.buckets is None:
            group = self.batch_size * self.accum
            n_full = len(order) // group
            ranges = [
                (order[i * group: (i + 1) * group], self.target_len, self.batch_size)
                for i in range(n_full)
            ]
            if not self.drop_last and len(order) % group:
                ranges.append((order[n_full * group:], self.target_len, self.batch_size))
            return ranges
        ranges = []
        buckets_of = self._item_bucket[order]
        for bi, blen in enumerate(self.buckets):
            sel = order[buckets_of == bi]
            bs = self._bucket_bs[bi]
            group = bs * self.accum
            n_full = len(sel) // group
            for i in range(n_full):
                ranges.append((sel[i * group: (i + 1) * group], blen, bs))
            if not self.drop_last and len(sel) % group:
                ranges.append((sel[n_full * group:], blen, bs))
        mix = np.random.default_rng((self.seed, self.epoch, 0xB0CC)).permutation(
            len(ranges)
        )
        return [ranges[int(i)] for i in mix]

    def remaining(self) -> int:
        """The batch groups of this epoch left from ``position``."""
        return max(0, len(self._epoch_plan()) - self.position)

    def _to_torch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        if self.pin_memory:
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def _make_batch(self, idxs, seed: int, blen: int, bs: int) -> Dict[str, torch.Tensor]:
        if self.use_native:
            items = self._make_group_native(idxs, seed, blen)
        else:
            w_rng = np.random.default_rng(seed)
            items = [self._make_item(i, w_rng, blen) for i in idxs]
        # pad the final short group by repeating items
        while len(items) < bs * self.accum:
            items.append(items[len(items) % max(1, len(idxs))])
        batch = self._collate(items, blen)
        if not self.train:
            # true item count so eval metrics can mask out the repeated
            # padding rows (train always drops last)
            batch["n_valid"] = np.int64(len(idxs))
        if self.train:  # training steps always expect (accum, B, ...)
            batch = {k: v.reshape((self.accum, bs) + v.shape[1:]) for k, v in batch.items()}
        return self._to_torch(batch)

    def _epoch_batches(self) -> Iterator[Dict[str, torch.Tensor]]:
        ranges = self._epoch_plan()
        # mid-epoch resume: skip groups already consumed before the restore
        # (all of them when the state was saved after the epoch's last batch)
        start = min(self.position, len(ranges))
        self.position = start
        ranges = ranges[start:]

        work_q: "queue.Queue" = queue.Queue()
        out_q: "queue.Queue" = queue.Queue(maxsize=self.num_workers * 2)
        stop = threading.Event()  # set when the consumer leaves the epoch early

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            while not stop.is_set():
                task = work_q.get()
                if task is None:
                    return
                pos = task[0]
                try:
                    batch = self._make_batch(*task[1:])
                except Exception as e:  # raised by the consumer
                    batch = e
                if not put((pos, batch)):
                    return

        for pos, (idxs, blen, bs) in enumerate(ranges):
            work_q.put((pos, idxs, self._group_seed(start + pos), blen, bs))
        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            work_q.put(None)
            t.start()

        pending: Dict[int, Dict] = {}
        next_pos = 0
        try:
            for _ in range(len(ranges)):
                pos, batch = out_q.get()
                if isinstance(batch, Exception):
                    raise batch
                pending[pos] = batch
                while next_pos in pending:
                    batch_out = pending.pop(next_pos)
                    next_pos += 1
                    self.position = start + next_pos
                    yield batch_out
            self.position = 0  # epoch fully consumed
        finally:
            stop.set()
            for t in threads:
                t.join()

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self._epoch_batches()
