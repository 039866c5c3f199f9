"""BatVision V1/V2 loaders and the dataset factory (port of
`data/batvision.py`).

The host scans the annotation CSVs and decodes each sample's WAV (or .npy
waveforms) and depth map into a fixed-length waveform and a
nearest-resized depth map; every piece of signal processing (STFT, mel,
log, min-max) runs on the device in the task's front end.

Sample semantics (those of the JAX loaders):
  * BV2: the per-location CSVs concatenated in sorted directory order,
    skipping '.'-, '__'-prefixed and '_unzipped' directories, warning and
    skipping a location without the CSV; depth .npy mm → m, clipped to
    [0, max_depth] with negatives → 0, cv2 INTER_NEAREST resize; the WAV
    decoded by scipy with int16/int32 scaling; the waveform cut or
    zero-padded to int((2·max_depth/340)·sr) samples. BV2 never normalizes
    depth, whatever cfg.dataset.depth_norm says.
  * BV1: one root CSV; NaN/±inf depth scrubbed; the two mono .npy waveforms
    stacked L/R; depth ÷ max_depth when depth_norm.
  * the location blacklist (BV2: exact directory names; BV1: a substring of
    'audio path left') and the holdout loaders (`filter_by_audio_path`, a
    literal substring match).

The CSVs are read with the standard library's `csv` module, every cell as
a string. pandas, which the JAX loaders use, parses a column of numbers as
numbers and an empty cell as NaN; here such a cell stays the string it is
in the file ('12', ''). The columns the loaders read are paths and file
names, which are strings either way. pandas is not needed.

Every `batches()` takes `shard=(rank, world_size)` for data-parallel
training: each rank then reads only its contiguous rows of every global
batch (`parallel.local_batch_slice`) of the same epoch permutation.

BV2's `batches()` decodes in the native thread pool (`data/native_io.py`)
and yields the compact transport dtypes (int16 waveform, uint16 depth);
`batches(native=False)` and BV1 yield float32 from the Python decoder.

Camera images (BV2 only): `use_image` True gives the image instead of the
audio, "both" the paired audio and image (the distillation trainer's
pairing). The pixels are OpenCV's: `cv2.imread` → BGR2RGB → `cv2.resize`
to images_size² with its default INTER_LINEAR, in uint8 (the transport
dtype; `sample` divides by 255, the codec's decode does so on the device).
Another decoder would give other pixels, so cv2 is imported on the image
path only and its absence raises. The batched path decodes a batch's
images in a thread pool (cv2 releases the GIL) while the native pool
decodes its audio and depth.
"""

from __future__ import annotations

import concurrent.futures
import copy
import csv
import functools
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..configs import Config
from ..parallel.multihost import local_batch_slice
from ..ops.resize import resize_nearest_cv2_np
from .frontend import tof_cut_samples

# (rank, world_size) of a data-parallel loader; None reads whole batches
Shard = Optional[Tuple[int, int]]


def load_wav(path: str):
    """Decode a WAV file to float32 [C, L] and its sample rate."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.ndim == 1:
        data = data[:, None]
    data = data.T  # [C, L]
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, sr


def _fix_length(wave_arr: np.ndarray, length: int) -> np.ndarray:
    c, l = wave_arr.shape
    if l >= length:
        return wave_arr[:, :length]
    out = np.zeros((c, length), np.float32)
    out[:, :l] = wave_arr
    return out


def _load_depth(path: str, size: int, max_depth: float, scrub_nan: bool) -> np.ndarray:
    depth = np.load(path).astype(np.float32)
    if scrub_nan:
        # np.nan_to_num's defaults: NaN → 0, +inf → FLT_MAX (the clip below
        # maps it to max_depth), -inf → -FLT_MAX (the negative floor → 0)
        depth = np.nan_to_num(depth)
    depth = depth / 1000.0
    if max_depth:
        depth[depth > max_depth] = max_depth
    depth[depth < 0] = 0.0
    return resize_nearest_cv2_np(depth, size, size)


def _read_csv(path: str) -> List[Dict[str, str]]:
    """The rows of a CSV with a header line, each a {column: string} dict."""
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f))


@functools.lru_cache(maxsize=None)
def _image_pool() -> concurrent.futures.ThreadPoolExecutor:
    """The thread pool of camera-image decodes: ADEPTH_IMAGE_THREADS
    threads (default 8, the native pool's), as the JAX package sizes it."""
    return concurrent.futures.ThreadPoolExecutor(
        max_workers=int(os.environ.get("ADEPTH_IMAGE_THREADS", "8")))


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("camera images need OpenCV (cv2), which does not import: "
                          f"its decode and resize define the pixels ({e})") from e
    return cv2


def _decode_image_u8(path: str, size: int) -> np.ndarray:
    """cv2 decode → RGB → resize (INTER_LINEAR), uint8 [size, size, 3]."""
    cv2 = _cv2()
    img = cv2.imread(path)
    if img is None:
        raise IOError(f"could not load image {path}")
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return cv2.resize(img, (size, size))


class BatvisionV2Dataset:
    def __init__(
        self,
        cfg: Config,
        annotation_file: str,
        location_blacklist: Optional[Sequence[str]] = None,
        use_image=False,
    ):
        self.cfg = cfg
        self.use_image = use_image
        ds = cfg.dataset
        self.root = ds.dataset_dir
        self.wave_len = tof_cut_samples(ds.max_depth, ds.sample_rate)

        locations = [
            d for d in sorted(os.listdir(self.root))
            if os.path.isdir(os.path.join(self.root, d))
            and not d.startswith(".") and not d.startswith("__")
            and not d.endswith("_unzipped")
        ]
        if location_blacklist:
            locations = [l for l in locations if l not in location_blacklist]
        rows: List[Dict[str, str]] = []
        found = False
        for loc in locations:
            csv_path = os.path.join(self.root, loc, annotation_file)
            if os.path.exists(csv_path):
                rows.extend(_read_csv(csv_path))
                found = True
            else:
                print(f"Warning: {csv_path} not found, skipping location {loc}")
        if not found:
            raise ValueError(f"No valid locations with {annotation_file} in {self.root}")
        self.instances = rows

    def __len__(self):
        return len(self.instances)

    def filter_by_audio_path(self, substring: str) -> "BatvisionV2Dataset":
        """Holdout loader: the rows whose audio path holds `substring`."""
        clone = copy.copy(self)
        clone.instances = [r for r in self.instances if substring in r["audio path"]]
        return clone

    def _paths(self, row: Dict[str, str]):
        return (os.path.join(self.root, row["audio path"], row["audio file name"]),
                os.path.join(self.root, row["depth path"], row["depth file name"]))

    def _image_path(self, row: Dict[str, str]) -> str:
        return os.path.join(self.root, row["camera path"], row["camera file name"])

    @property
    def _wants_audio(self) -> bool:
        return not self.use_image or self.use_image == "both"

    def sample(self, idx: int) -> Dict[str, np.ndarray]:
        ds = self.cfg.dataset
        row = self.instances[idx]
        wav_path, depth_path = self._paths(row)
        depth = _load_depth(depth_path, ds.images_size, ds.max_depth, scrub_nan=False)
        out = {"depth": depth[..., None]}
        if self.use_image:
            img = _decode_image_u8(self._image_path(row), ds.images_size)
            out["image"] = img.astype(np.float32) / 255.0
        if self._wants_audio:
            wav, _ = load_wav(wav_path)
            out["waveform"] = _fix_length(wav, self.wave_len)
        return out

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True, native: bool = True, shard: Shard = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Batch iterator. native=True decodes WAV and depth in the native
        thread pool, and images in the image pool, and yields int16 waveform
        / uint16 depth / uint8 image (the compact transport dtypes);
        native=False yields `sample`'s float32."""
        if not native:
            yield from _batch_iter(self, batch_size, shuffle, seed, drop_last, shard)
            return
        from . import native_io

        size = self.cfg.dataset.images_size
        for idx in _batch_order(len(self), batch_size, shuffle, seed, drop_last, shard):
            rows = [self.instances[int(j)] for j in idx]
            images = None
            if self.use_image:
                pool = _image_pool()
                images = [pool.submit(_decode_image_u8, self._image_path(r), size) for r in rows]
            wavs, depths = zip(*map(self._paths, rows))
            wav, depth = native_io.assemble_batch(
                list(wavs) if self._wants_audio else None, list(depths), fixed_len=self.wave_len,
                out_hw=(size, size),
                # BV2 keeps meters whatever depth_norm says, as sample() does
                # (codec.depth_storage_normalized)
                max_depth=self.cfg.dataset.max_depth, depth_norm=False)
            out = {"depth": depth}
            if wav is not None:
                out["waveform"] = wav
            if images is not None:
                out["image"] = np.stack([f.result() for f in images])
            yield out


class BatvisionV1Dataset:
    def __init__(
        self,
        cfg: Config,
        annotation_file: str,
        location_blacklist: Optional[Sequence[str]] = None,
        waveform_len: Optional[int] = None,
    ):
        self.cfg = cfg
        self.root = cfg.dataset.dataset_dir
        self.instances = _read_csv(os.path.join(self.root, annotation_file))
        if location_blacklist:
            n0 = len(self.instances)
            for loc in location_blacklist:
                self.instances = [r for r in self.instances if loc not in r["audio path left"]]
            print(f"BatvisionV1: filtered {n0 - len(self.instances)} instances "
                  f"from blacklisted locations: {list(location_blacklist)}")
        self._wave_len = waveform_len

    def __len__(self):
        return len(self.instances)

    def filter_by_audio_path(self, substring: str) -> "BatvisionV1Dataset":
        """Holdout loader: the rows whose left-audio path holds `substring`.
        The clone keeps the parent's waveform length, so its batches have
        the train loader's [B, 2, L] even where its own first recording is
        shorter."""
        clone = copy.copy(self)
        clone._wave_len = self.wave_len
        clone.instances = [r for r in self.instances if substring in r["audio path left"]]
        return clone

    @property
    def wave_len(self) -> int:
        if self._wave_len is None:
            left = np.load(os.path.join(self.root, self.instances[0]["audio path left"]))
            self._wave_len = int(left.shape[-1])
        return self._wave_len

    def sample(self, idx: int) -> Dict[str, np.ndarray]:
        row = self.instances[idx]
        ds = self.cfg.dataset
        depth = _load_depth(os.path.join(self.root, row["depth path"]),
                            ds.images_size, ds.max_depth, scrub_nan=True)
        if ds.depth_norm:
            depth = depth / ds.max_depth
        left = np.load(os.path.join(self.root, row["audio path left"])).astype(np.float32)
        right = np.load(os.path.join(self.root, row["audio path right"])).astype(np.float32)
        wav = np.stack([left, right])
        return {"waveform": _fix_length(wav, self.wave_len), "depth": depth[..., None]}

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True, shard: Shard = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        yield from _batch_iter(self, batch_size, shuffle, seed, drop_last, shard)


def _batch_order(n: int, batch_size: int, shuffle: bool, seed: int, drop_last: bool,
                 shard: Shard = None):
    """The index arrays of an epoch's batches: a seeded permutation of
    range(n) when shuffling, cut into batch_size pieces (the ragged tail
    kept unless drop_last). With `shard=(rank, world_size)`, each global
    batch's rows of that rank (`parallel.local_batch_slice`, which refuses
    a batch the world does not divide)."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    end = n - batch_size + 1 if drop_last else n
    out = [order[i:i + batch_size] for i in range(0, max(end, 0), batch_size)]
    if shard is not None:
        out = [idx[local_batch_slice(len(idx), *shard)] for idx in out]
    return out


def _batch_iter(dataset, batch_size: int, shuffle: bool, seed: int, drop_last: bool,
                shard: Shard = None):
    for idx in _batch_order(len(dataset), batch_size, shuffle, seed, drop_last, shard):
        samples = [dataset.sample(int(j)) for j in idx]
        yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def make_dataset(cfg: Config, split: str = "train", **kwargs):
    """split in {train, val, test} → dataset object for cfg.dataset.name."""
    ds = cfg.dataset
    if ds.name == "synthetic":
        from .synthetic import SyntheticEchoDataset

        kwargs.setdefault("num_samples", {"train": 256, "val": 64, "test": 64}[split])
        kwargs.setdefault("seed", {"train": 0, "val": 1, "test": 2}[split])
        return SyntheticEchoDataset(cfg, **kwargs)
    ann = getattr(ds, f"annotation_file_{split}")
    if ds.name == "batvisionv1":
        return BatvisionV1Dataset(cfg, ann, **kwargs)
    if ds.name == "batvisionv2":
        return BatvisionV2Dataset(cfg, ann, **kwargs)
    raise ValueError(f"unknown dataset {ds.name!r}")
