"""Phases 13 and 18 of one checkout's ``chip_smoke.py`` (Llama-3.2-1B
served, then trained), for comparing two commits on one card in one
machine session: the kernels built from that checkout, then one line
``AB {...}`` with the serving step medians and the training step times.

    python chip_ab.py CHECKOUT_DIR LABEL

Run it for the parent and the change in turn (parent, change, change,
parent), each in its own process."""
import json
import os
import sys
import time

tree = os.path.abspath(sys.argv[1])
label = sys.argv[2]
os.chdir(tree)
sys.path.insert(0, os.path.join(tree, "src"))
sys.path.insert(0, tree)
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

from repro_torch.benchmarks.common import Timer  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

t0 = time.time()
_build.build()
dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
llama = cs.llama_phase(torch, dev, Timer())
serve = llama["record"]["serve"]["step_ms_median"]
tr = cs.training_phase(torch, dev, None)["record"]
print("AB", json.dumps({"label": label, "card": cs.smi_line(),
                        "serve_step_ms_median": serve,
                        "train_step_ms": tr["step_ms"],
                        "train_step_ms_median": tr["step_ms_median"],
                        "peak_allocated": tr["peak_allocated"],
                        "seconds": time.time() - t0}), flush=True)
