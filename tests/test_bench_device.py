"""bench.py measures a GPU or nothing: no CPU fallback, no default peak."""

import types

import pytest

import bench


def test_unknown_device_kind_is_an_error():
    dev = types.SimpleNamespace(device_kind="Unknown Accelerator", platform="gpu")
    with pytest.raises(KeyError, match="no peak rates"):
        bench.device_peaks(dev)


def test_h100_row_is_known():
    kind = next(iter(bench.PEAKS))
    peaks = bench.device_peaks(types.SimpleNamespace(device_kind=kind))
    assert "H100" in kind and peaks["hbm_tb_s"] > 0


def test_no_gpu_exits_nonzero(capsys):
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""     # no result line
