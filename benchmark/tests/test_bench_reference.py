"""The plain reference: what it may import, and its plumbing against the
port's plain CPU path at a tiny width, in float32, on seeded weights."""

import ast
import sys

import pytest
import torch

from harness.inputs import make_pairs, make_weights
from harness.spec import BENCH_DIR
from reference import build_net, mel_frontend

ALLOWED = {"torch", "numpy"} | set(sys.stdlib_module_names)


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").rglob("*.py")),
                         ids=lambda p: p.relative_to(BENCH_DIR / "reference").as_posix())
def test_reference_imports_only_torch_numpy_stdlib(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                continue
            tops = [node.module.split(".")[0]]
        else:
            continue
        for top in tops:
            assert top in ALLOWED, f"{path.name} imports {top}"


UNET = {"family": "unet_baseline", "dataset": "batvisionv2", "generator": "unet_128", "ngf": 8,
        "images_size": 128, "max_depth": 30.0, "sample_rate": 44100,
        "compute_dtype": "float32", "batch_size": 4}
BINAURAL = {"family": "binaural_attention", "dataset": "batvisionv2", "base_channels": 8,
            "attention_levels": [2, 3, 4, 5], "images_size": 32, "max_depth": 30.0,
            "sample_rate": 44100, "compute_dtype": "float32", "batch_size": 4}


def _port(cfg):
    from harness.port import make_port_task

    weights = make_weights(cfg, 5, "cpu")
    return weights, make_port_task(cfg, weights, "cpu")[1]


def test_front_end_matches_the_port():
    from audiodepth_tpu_torch.data.frontend import make_frontend
    from harness.port import port_config

    pairs = make_pairs(4, 3, BINAURAL, "cpu")
    ours = mel_frontend(pairs["waveform"], 32, 30.0, 44100)
    theirs = make_frontend(port_config(BINAURAL))(pairs["waveform"])
    assert ours.shape == theirs.shape == (4, 32, 32, 2)
    assert float((ours - theirs).abs().max()) < 1e-5


@pytest.mark.parametrize("cfg", [UNET, BINAURAL], ids=["unet", "binaural"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_net_matches_the_port(cfg, train):
    weights, task = _port(cfg)
    net = build_net(cfg)
    net.load_state_dict(weights, strict=True)
    net.train(train)
    task.model.train(train)
    x = torch.rand(4, cfg["images_size"], cfg["images_size"], 2, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ours = net(x)
        theirs = task.model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert float((ours - theirs).abs().max()) <= 1e-4 * float(theirs.abs().max())


def test_weights_made_alike_on_a_seed():
    a, b = make_weights(BINAURAL, 2 ** 31 + 9, "cpu"), make_weights(BINAURAL, 2 ** 31 + 9, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    gammas = [v for k, v in a.items() if k.endswith("gamma")]
    assert len(gammas) == 4 and all(0.25 <= abs(float(g)) <= 1.0 for g in gammas)
    c = make_weights(BINAURAL, 2 ** 31 + 10, "cpu")
    assert not torch.equal(a["outc.0.weight"], c["outc.0.weight"])


def test_pairs_are_on_the_codec_grid():
    """16-bit PCM and uint16 depth: the compact transport carries them exactly."""
    from audiodepth_tpu_torch.data.codec import decode_batch, encode_batch

    pairs = make_pairs(6, 2 ** 32 + 1, UNET, "cpu")
    host = {k: v.numpy() for k, v in pairs.items()}
    enc = encode_batch(host, 30.0)
    dec = decode_batch({k: torch.from_numpy(v) for k, v in enc.items()}, 30.0)
    assert torch.equal(dec["waveform"], pairs["waveform"])
    assert torch.equal(dec["depth"], pairs["depth"])
    assert pairs["waveform"].shape == (6, 2, 7782 + 256)
    assert float((pairs["depth"] == 0).float().mean()) > 0
