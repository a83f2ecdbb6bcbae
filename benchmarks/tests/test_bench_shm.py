"""Local-mode Data, as the cells drive it (a from_numpy zip through
iter_torch_batches, a callable class through map_batches), writes no
store to /dev/shm and nothing under a fixed /tmp path."""

import os
import subprocess
import sys

from benchmarks import harness

CODE = """
import numpy as np, ray_tpu_torch
from ray_tpu_torch import data
ray_tpu_torch.init(local_mode=True)
ds = data.from_numpy(np.zeros((64, 4, 4, 3), np.float32), "image",
                     override_num_blocks=4).zip(
    data.from_numpy(np.arange(64), "label", override_num_blocks=4))
n = sum(len(b["label"]) for b in ds.iter_torch_batches(
    batch_size=8, device="cpu", device_prefetch=2))
class Stage:
    def __call__(self, batch):
        return {"x": batch["label"] * 2}
m = sum(len(b["x"]) for b in ds.map_batches(
    Stage, batch_size=8, concurrency=1).iter_batches(batch_size=None))
ray_tpu_torch.shutdown()
from ray_tpu_torch._private.config import shm_prefix
print(n, m, shm_prefix())
"""


def test_local_mode_data_leaves_no_shared_memory(tmp_path):
    shm_before = set(os.listdir("/dev/shm"))
    tmp_before = set(os.listdir("/tmp"))
    env = dict(os.environ, TMPDIR=str(tmp_path),
               PYTHONPATH=harness.ROOT)
    r = subprocess.run([sys.executable, "-c", CODE], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    n, m, prefix = r.stdout.split()[-3:]
    assert (n, m) == ("64", "64")
    new_shm = set(os.listdir("/dev/shm")) - shm_before
    assert not [f for f in new_shm if f.startswith(prefix)]
    new_tmp = set(os.listdir("/tmp")) - tmp_before
    assert not [f for f in new_tmp if f.startswith("rtt")]
