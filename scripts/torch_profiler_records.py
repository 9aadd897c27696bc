"""Does torch.profiler keep the kernel records of the port's ctypes
libraries?  It depends on when the library is compiled (Queue 3 item 12 of
ROADMAP.md).

    python scripts/torch_profiler_records.py ORDER     (on a CUDA card)

ORDER is one of
  build_first      compile gather_rows and take_along_rows in this process
                   (nvcc), then trace;
  trace_first      trace a PyTorch kernel first, then compile both in this
                   process, then trace them;
  trace_then_lazy  trace a PyTorch kernel first, then let each wrapper
                   compile its library at its first call, one after the
                   other (the order the GPU tests once had);
  prebuilt_first   compile both in another process, trace a PyTorch kernel,
                   then load and trace them.
Each run deletes nothing: start it with ``build/kernels/`` absent.  It
prints the card, then the kernel records of 40 traces of one call each (a
call launches one kernel; 0 means the trace dropped it).  On an NVIDIA H100
80GB HBM3 (700 W, torch 2.11.0+cu128), in one machine: trace_then_lazy
dropped 26 of 40 (take_along_rows) and 35 of 40 (gather_rows_sum) in one
process and none in another; prebuilt_first dropped 3 of 40
(gather_rows_sum); trace_first and build_first none.
"""

import json
import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def records(fn) -> int:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


def main(order: str) -> None:
    if order not in ("build_first", "trace_first", "trace_then_lazy", "prebuilt_first"):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from mast3r_slam_tpu_torch.ops import gather, kernels

    names = ["gather_rows", "take_along_rows"]
    if order == "prebuilt_first":
        subprocess.run([sys.executable, "-c", "from mast3r_slam_tpu_torch.ops import kernels; "
                        f"kernels.build_all({names!r})"], check=True)
    elif order == "build_first":
        kernels.build_all(names)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    if order != "build_first":
        x = torch.ones(8, device="cuda")
        print("a PyTorch kernel first:", records(lambda: x.sum()), "records")
    if order == "trace_first":
        kernels.build_all(names)
    g = torch.Generator(device="cuda").manual_seed(0)
    tab = torch.randint(-100, 100, (5000, 12), device="cuda", generator=g).float()
    idx = torch.randint(0, 5000, (3000, 12), device="cuda", generator=g, dtype=torch.int32)
    table = torch.randint(-100, 100, (5000, 32), device="cuda", generator=g).to(torch.int8)
    rows = torch.randint(0, 5000, (20000,), device="cuda", generator=g, dtype=torch.int32)
    calls = {"take_along_rows": lambda: gather.take_along_rows_cuda(tab, idx, slab_bytes=64),
             "gather_rows_sum": lambda: gather.gather_rows_sum(table, rows)}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    print(json.dumps({"order": order, "torch": torch.__version__,
                      "records_a_trace": {k: [records(fn) for _ in range(40)]
                                          for k, fn in calls.items()}}))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "")
