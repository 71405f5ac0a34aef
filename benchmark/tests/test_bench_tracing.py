"""The trace reader on a hand-written Chrome trace."""

import json

from benchmark import tracing


def test_summary_of_a_small_trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "find_split", "ts": 0,
         "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 10,
         "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 70, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "digit_hist_kernel<u8>", "ts": 0,
         "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "digit_hist_kernel<u8>", "ts": 10,
         "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 80,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "scan", "ts": 150, "dur": 50},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    s = tracing.summarize(str(p))
    assert abs(s["window_s"] - 200e-6) < 1e-12
    # busy: [0, 30] + [80, 90] + [150, 200]
    assert abs(s["busy_s"] - 90e-6) < 1e-12
    assert abs(tracing.idle_pct(s) - 55.0) < 1e-9
    assert s["kernel_count"] == 3
    n, sec = tracing.kernel_seconds(s, "digit_hist")
    assert n == 2 and abs(sec - 40e-6) < 1e-12
    assert abs(s["ranges"]["find_split"] - 100e-6) < 1e-12
    gaps = dict(s["idle_gaps"])
    # [30, 80] (middle 55: inside aten::item), [90, 150] (middle 120:
    # after the range)
    assert abs(gaps["find_split: aten::item"] - 50e-6) < 1e-12
    assert abs(gaps["no range: no host op"] - 60e-6) < 1e-12
    assert s["device_ops"][0][0] == "scan"
