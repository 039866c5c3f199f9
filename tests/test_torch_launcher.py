"""The launcher every kernel wrapper derives from (`ops/cuda/_build.py`),
on the CPU:
  * no wrapper of `KERNELS` has loaded its library after import;
  * a failed launch raises with the wrapper's name and the library's error
    string and counts nothing; a good one counts its launches and variant.
"""

from __future__ import annotations

import pytest

from audiodepth_tpu_torch.ops.cuda import KERNELS, _build


class _FakeLibrary:
    def adepth_cuda_error_string(self, err):
        return f"fake error {err}".encode()


@pytest.mark.parametrize("wrapper", [w for w, _, _ in KERNELS], ids=lambda w: w.name)
def test_nothing_loaded_on_import(wrapper):
    assert isinstance(wrapper, _build.Launcher)
    assert wrapper._lib is None
    assert _build.load.cache_info().currsize == 0


@pytest.mark.parametrize("wrapper", [w for w, _, _ in KERNELS], ids=lambda w: w.name)
def test_check_raises_and_counts_nothing_on_failure(wrapper):
    fake = type(wrapper)(library=_FakeLibrary)
    with pytest.raises(RuntimeError, match=f"^{wrapper.name} launch failed: fake error 700$"):
        fake._check(700, "v")
    assert fake.launches == 0 and not fake.variant_launches
    fake._check(0, "v", 2)
    fake._check(0, "w")
    assert fake.launches == 3 and fake.variant_launches == {"v": 1, "w": 1}
