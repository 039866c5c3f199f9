"""Fabricated BatVision trees for the port's tests (the layouts of
tests/test_batvision_data.py's fixtures, copied here, with val and test
splits added for the training and evaluation tests, and camera PNGs for the
image loaders)."""

from __future__ import annotations

import wave as wavemod

import numpy as np

BV2_HEADER = ("audio path,audio file name,depth path,depth file name,"
              "camera path,camera file name")


def write_wav(path, data, sr=44100):
    """data: [C, L] float32 in [-1,1] → 16-bit PCM."""
    pcm = (np.clip(data, -1, 1) * 32767).astype(np.int16)
    with wavemod.open(str(path), "wb") as f:
        f.setnchannels(pcm.shape[0])
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.T.tobytes())


def write_bv2_tree(root, locations=("Hall", "Office"),
                   rows=(("train", 3),), depth_hw=(48, 64), wave_len=9000, seed=0,
                   camera_hw=(48, 64), depth_prefix=""):
    """A BV2 tree: per location, `audio/` WAVs, `depth/` .npy depth in mm
    (values below 0 and above 30 m) named {depth_prefix}{split}{i}.npy
    (the sparse-depth preprocessor reads depth_*.npy), `cam/` camera PNGs of
    camera_hw (random BGR pixels, written by OpenCV), and one CSV per
    (split, row count); plus a '__pycache__' and an 'X_unzipped' directory
    the scan skips."""
    import cv2

    rng = np.random.default_rng(seed)
    cam_rng = np.random.default_rng(seed + 1)  # the audio and depth draws stay as they were
    for loc in locations:
        d = root / loc
        (d / "audio").mkdir(parents=True)
        (d / "depth").mkdir()
        (d / "cam").mkdir()
        for split, n in rows:
            lines = []
            for i in range(n):
                name = f"{split}{i}"
                depth_mm = rng.uniform(-500, 40000, size=depth_hw).astype(np.float32)
                np.save(d / "depth" / f"{depth_prefix}{name}.npy", depth_mm)
                write_wav(d / "audio" / f"{name}.wav",
                          rng.normal(0, 0.1, size=(2, wave_len)).astype(np.float32))
                bgr = cam_rng.integers(0, 256, size=(*camera_hw, 3), dtype=np.uint8)
                assert cv2.imwrite(str(d / "cam" / f"{name}.png"), bgr)
                lines.append(f"{loc}/audio,{name}.wav,{loc}/depth,{depth_prefix}{name}.npy,"
                             f"{loc}/cam,{name}.png")
            (d / f"{split}.csv").write_text(BV2_HEADER + "\n" + "\n".join(lines) + "\n")
    (root / "__pycache__").mkdir()
    (root / "X_unzipped").mkdir()
    return root


def write_bv1_tree(root, lengths=(("seqA", 4000), ("seqA", 4000), ("seqB", 4000)),
                   depth_hw=(32, 32), seed=1):
    """A BV1 tree: one root train.csv; per row a depth .npy in mm with a NaN
    and a +inf pixel, and left/right mono .npy waveforms of the given
    length."""
    rng = np.random.default_rng(seed)
    lines = []
    for i, (loc, length) in enumerate(lengths):
        (root / loc).mkdir(exist_ok=True)
        depth_mm = rng.uniform(-100, 15000, size=depth_hw).astype(np.float32)
        depth_mm[0, 0] = np.nan
        depth_mm[0, 1] = np.inf
        np.save(root / loc / f"d{i}.npy", depth_mm)
        for side in ("l", "r"):
            np.save(root / loc / f"{side}{i}.npy", rng.normal(size=length).astype(np.float32))
        lines.append(f"{loc}/d{i}.npy,{loc}/l{i}.npy,{loc}/r{i}.npy")
    (root / "train.csv").write_text(
        "depth path,audio path left,audio path right\n" + "\n".join(lines) + "\n")
    return root


def write_wav_fmt(path, data, fmt):
    """Raw RIFF writer of tests/test_native_io.py's format fixtures.

    fmt: pcm16 | pcm24 | pcm32 | f32 | ext_pcm16 (WAVE_FORMAT_EXTENSIBLE).
    data: float32 [C, L] in [-1, 1].
    """
    import struct

    ch, n = data.shape
    inter = np.ascontiguousarray(data.T)  # [L, C]
    if fmt == "pcm16":
        tag, bits = 1, 16
        body = (np.clip(inter, -1, 1) * 32767).astype("<i2").tobytes()
    elif fmt == "pcm24":
        tag, bits = 1, 24
        v = (np.clip(inter, -1, 1) * 8388607).astype(np.int64)
        body = b"".join(int(x).to_bytes(3, "little", signed=True) for x in v.ravel())
    elif fmt == "pcm32":
        tag, bits = 1, 32
        body = (np.clip(inter, -1, 1) * 2147483392).astype("<i4").tobytes()
    elif fmt == "f32":
        tag, bits = 3, 32
        body = inter.astype("<f4").tobytes()
    elif fmt == "ext_pcm16":
        tag, bits = None, 16
        body = (np.clip(inter, -1, 1) * 32767).astype("<i2").tobytes()
    else:
        raise ValueError(fmt)
    sr = 44100
    block = ch * bits // 8
    if fmt == "ext_pcm16":
        # KSDATAFORMAT_SUBTYPE_PCM: 00000001-0000-0010-8000-00aa00389b71
        sub = bytes.fromhex("01000000" "0000" "1000" "800000aa00389b71")
        fmt_chunk = struct.pack("<HHIIHHHHI", 0xFFFE, ch, sr, sr * block,
                                block, bits, 22, bits, 0x3) + sub
    else:
        fmt_chunk = struct.pack("<HHIIHH", tag, ch, sr, sr * block, block, bits)
    blob = (b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
            + b"data" + struct.pack("<I", len(body)) + body)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(blob)) + b"WAVE" + blob)
