"""The traced run's reading of Chrome traces: from the stretch of device
activity alone, busy time as the union of device intervals and kernel
time by name; from the stretch with the host's, each idle gap named by
the innermost host operation over its middle."""

import pytest

from bench_port.harness.trace import WINDOW, read_device, read_idle_gaps


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


DEVICE = [
    ev("kernel", "void flash_fwd_a_sm90<64>(...)", 10, 20),
    ev("kernel", "elementwise", 25, 15),    # overlaps the first
    ev("gpu_memcpy", "Memcpy DtoH", 70, 20),
]


def test_read_trace():
    rec = read_device(DEVICE + [ev("cuda_runtime", "cudaLaunchKernel", 9, 2)],
                      window_s=100e-6)
    assert rec["busy_s"] == pytest.approx(50e-6)
    assert rec["window_s"] == pytest.approx(100e-6)
    assert rec["n_kernels"] == 2
    assert rec["kernels"]["Memcpy DtoH"] == pytest.approx(20e-6)
    assert rec["device_ops"][0][0] == "void flash_fwd_a_sm90<64>(...)"


def test_idle_gaps_named_by_the_host():
    events = DEVICE + [
        ev("user_annotation", WINDOW, 0, 100),
        ev("cpu_op", "aten::conv2d", 0, 50),
        ev("cpu_op", "aten::convolution", 2, 20),
        ev("cpu_op", "aten::copy_", 60, 40),
    ]
    # 0-10 inside conv2d's convolution; 40-70 between host operations;
    # 90-100 inside copy_
    assert dict(read_idle_gaps(events)) == pytest.approx(
        {"aten::convolution": 10e-6, "host between operations": 30e-6,
         "aten::copy_": 10e-6})


def test_a_trace_without_device_work_is_refused():
    with pytest.raises(RuntimeError, match="no device operation"):
        read_device([ev("cuda_runtime", "cudaLaunchKernel", 0, 10)], 1.0)
    with pytest.raises(RuntimeError, match="no device operation"):
        read_idle_gaps([ev("user_annotation", WINDOW, 0, 10)])
