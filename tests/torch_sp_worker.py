"""One rank of the two-process sequence-parallel run of
tests/test_torch_sp.py (the port only; no JAX).

argv: (rank, out_dir, dense checkpoint, packed checkpoint); the
environment carries WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT as torchrun sets them. Joins a gloo group and writes
out<rank>.npz: the ring prefill's logits and five SPCache decode steps'
logits, one step from the JAX package's prefill cache (in.npz), and
SPEngine.generate's tokens on the packed model with fused a8 weights.
Then runs the CLI with --sp 2 (rank 0 prints its result line) and prints
SP_OK.
"""

import os
import sys

rank, out_dir, dense_path, packed_path = (int(sys.argv[1]), *sys.argv[2:])

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from gptq_tpu_torch import cli  # noqa: E402
from gptq_tpu_torch import io as tio  # noqa: E402
from gptq_tpu_torch.engine.serving import SPEngine  # noqa: E402
from gptq_tpu_torch.parallel import sp as tsp  # noqa: E402
from gptq_tpu_torch.weights import sp_cache_from_jax  # noqa: E402

dist.init_process_group("gloo", init_method="env://")
assert dist.get_world_size() == 2 and dist.get_rank() == rank
inp = np.load(os.path.join(out_dir, "in.npz"))
out = {}

spec, params, _ = tio.load_checkpoint(dense_path, device="cpu")
ids = torch.from_numpy(inp["ids"])
logits, cache = tsp.make_sp_cache_prefill(
    spec, params, cache_dtype=torch.float32, max_len=16, device="cpu")(ids)
out["prefill"] = logits.numpy()
step = tsp.make_sp_decode_step(spec, params, cache.meta)
steps = []
for t in inp["toks"].tolist():
    lg, cache = step(cache, torch.tensor([[t], [t]]))
    steps.append(lg.numpy())
out["steps"] = np.stack(steps)
assert cache.length == 8 + len(steps)

jcache = {k[len("jcache_"):]: inp[k] for k in inp.files
          if k.startswith("jcache_")}
carried = sp_cache_from_jax(jcache, rank=rank, device="cpu")
t = int(inp["toks"][0])
out["carry"], _ = step(carried, torch.tensor([[t], [t]]))

pspec, pparams, _ = tio.load_checkpoint(packed_path, device="cpu")
eng = SPEngine(pspec, pparams, sp=2, max_len=32, fuse=True, a8=True,
               device="cpu")
out["generate"] = eng.generate(inp["prompt"], 8, chunk=4)
np.savez(os.path.join(out_dir, f"out{rank}.npz"),
         **{k: np.asarray(v) for k, v in out.items()})

assert cli.main(["dummy", "c4", "--load", packed_path, "--benchmark", "16",
                 "--faster-kernel", "--sp", "2", "--device", "cpu"]) == 0
dist.destroy_process_group()
print("SP_OK", flush=True)
