"""The port's utils (tencent_recommendation_2025_tpu_torch/utils/): the data
directory report as the JAX package prints it, the system info's keys, and
the debug switches restored on the way out of their scope."""

import os

import pytest
import torch

from tencent_recommendation_2025_tpu.utils import sysinfo as JSI
from tencent_recommendation_2025_tpu_torch.utils import debug, sysinfo


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_parse_data_path_structure_matches_jax(synth_dir, tmp_path, depth):
    (tmp_path / "a" / "b").mkdir(parents=True)
    (tmp_path / "a" / "b" / "c.bin").write_bytes(b"x" * 3000)
    (tmp_path / "top.txt").write_text("hello")
    for root in (synth_dir, tmp_path, tmp_path / "missing"):
        assert sysinfo.parse_data_path_structure(root, depth) == \
            JSI.parse_data_path_structure(root, depth)


def test_format_file_size_matches_jax():
    for n in (0, 1023, 1024, 5 * 2 ** 20, 3.5 * 2 ** 30, 2 ** 50):
        assert sysinfo.format_file_size(n) == JSI.format_file_size(n)


def test_print_system_info_keys(capsys):
    info = sysinfo.print_system_info()
    keys = {"platform", "python", "cpu_count", "torch_version", "cuda",
            "device_count", "devices"}
    assert keys <= set(info)
    assert not any(k.startswith("jax") for k in info)
    assert info["torch_version"] == torch.__version__
    assert info["cuda"] == torch.version.cuda
    assert info["device_count"] == len(info["devices"])
    assert info["cpu_count"] == os.cpu_count()
    out = capsys.readouterr().out
    for k in keys:
        assert f"  {k}: " in out


def _switches():
    return (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled(),
            torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())


def test_debug_mode_restores_the_switches():
    before = _switches()
    with debug.debug_mode(nans=True, checks=True):
        assert _switches() == (True, True, True, True)
    assert _switches() == before
    with pytest.raises(RuntimeError):
        with debug.debug_mode(nans=True):
            assert torch.is_anomaly_enabled()
            raise RuntimeError("inside")
    assert _switches() == before


def test_nan_check_names_the_op():
    x = torch.tensor([-1.0], requires_grad=True)
    with debug.debug_mode(nans=True):
        with pytest.raises(RuntimeError, match="nan|NaN"):
            torch.sqrt(x).sum().backward()
    assert not torch.is_anomaly_enabled()


def test_enable_switches_and_profile_trace(tmp_path):
    before = _switches()
    try:
        debug.enable_checks(True)
        assert torch.are_deterministic_algorithms_enabled()
        debug.enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
    finally:
        debug.enable_checks(False)
        debug.enable_nan_checks(False)
    assert _switches()[2:] == before[2:] and not torch.is_anomaly_enabled()
    with debug.profile_trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
