"""One rank of the multi-process tensor- / expert-parallel runs of
tests/test_torch_tp.py and tests/test_torch_ep.py (the port only; no JAX).

argv: (job, out_dir); the environment carries WORLD_SIZE, RANK,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT as torchrun sets them. The rank
joins a gloo group through parallel/distributed.init_distributed, reads
in.npz and the checkpoints the test wrote into out_dir, writes
<job><rank>.npz and prints <JOB>_OK.

  tp (2 ranks): dense f32 prefill + decode and forward, packed act-order
     fused a8 decode on an int8 cache (with greedy tokens), the
     act-order forward, BLOOM's decode, a BCQ forward, DecodeEngine's
     generate and generate_chained over the group, and the CLI's --tp 2;
  ep (2 ranks): dense forward, int8-cache decode and the capacity-bound
     forward of an MoE model, EPEngine.generate on packed expert banks,
     and the CLI's --ep 2;
  eptp (4 ranks, ep 2 x tp 2): packed fused a8 attention with int8
     experts, prefill + decode; a dense forward.
"""

import os
import sys

job, out_dir = sys.argv[1], sys.argv[2]

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from gptq_tpu_torch import cli  # noqa: E402
from gptq_tpu_torch import io as tio  # noqa: E402
from gptq_tpu_torch.engine.decode import DecodeEngine  # noqa: E402
from gptq_tpu_torch.engine.serving import EPEngine  # noqa: E402
from gptq_tpu_torch.models.common import KVCache  # noqa: E402
from gptq_tpu_torch.parallel import ep as tep  # noqa: E402
from gptq_tpu_torch.parallel import tp as ttp  # noqa: E402
from gptq_tpu_torch.parallel.distributed import init_distributed  # noqa
from gptq_tpu_torch.parallel.mesh import make_layout  # noqa: E402

torch.set_num_threads(1)
device = init_distributed("cpu")
rank = dist.get_rank()
inp = np.load(os.path.join(out_dir, "in.npz"))
prompt = torch.from_numpy(inp["prompt"])
ids = torch.from_numpy(inp["ids"])
toks = inp["toks"].tolist()
out = {}


def load(name):
    return tio.load_checkpoint(os.path.join(out_dir, name), device="cpu")[:2]


def run(step, cache, greedy=0):
    """Prefill the prompt, feed toks, then `greedy` argmax tokens: (the
    logits of each call (n, vocab), the greedy tokens)."""
    outs, picked = [], []
    lg, cache = step(cache, prompt)
    outs.append(lg[0])
    for t in toks:
        lg, cache = step(cache, torch.tensor([[t]]))
        outs.append(lg[0])
    for _ in range(greedy):
        t = int(torch.argmax(lg[0]))
        picked.append(t)
        lg, cache = step(cache, torch.tensor([[t]]))
        outs.append(lg[0])
    return torch.stack(outs).numpy(), np.asarray(picked)


if job == "tp":
    spec, params = load("dense.npz")
    local, step = ttp.make_tp_decode_step(spec, params)
    out["vocab_tp"] = local["lm_head"]["serve"].vocab_tp
    out["dense"], _ = run(step, ttp.local_cache(spec, 2, 1, 16,
                                                torch.float32, "cpu"))
    _, fwd = ttp.make_tp_forward(spec, params)
    out["dense_fwd"] = fwd(ids).numpy()

    spec, params = load("packed.npz")
    local, step = ttp.make_tp_decode_step(spec, params, fuse=True, a8=True)
    out["qkv_fused"] = "qkv_fused" in local["layers"][0]
    out["a8"], out["a8_greedy"] = run(
        step, ttp.local_cache(spec, 2, 1, 16, torch.int8, "cpu"), greedy=4)
    _, fwd = ttp.make_tp_forward(spec, params)
    out["actorder_fwd"] = fwd(ids).numpy()
    eng = DecodeEngine(spec, local, max_len=16, cache_dtype=torch.int8,
                       tp=ttp.shard_group())
    out["generate"] = eng.generate(prompt, 5)
    out["chained"] = eng.generate_chained(prompt, 5, chunk=2)

    bspec, bparams = load("bloom.npz")
    _, step = ttp.make_tp_decode_step(bspec, bparams)
    out["bloom"], _ = run(step, ttp.local_cache(bspec, 2, 1, 16,
                                                torch.float32, "cpu"))
    spec, params = load("bcq.npz")
    _, fwd = ttp.make_tp_forward(spec, params)
    out["bcq_fwd"] = fwd(ids).numpy()
    np.savez(os.path.join(out_dir, f"tp{rank}.npz"), **out)
    assert cli.main(["dummy", "c4", "--load",
                     os.path.join(out_dir, "packed.npz"), "--benchmark", "12",
                     "--faster-kernel", "--int8_kv", "--check", "--tp", "2",
                     "--device", "cpu"]) == 0

elif job == "ep":
    spec, params = load("moe.npz")
    _, fwd = tep.make_ep_forward(spec, params)
    out["fwd"] = fwd(ids).numpy()
    _, step = tep.make_ep_decode_step(spec, params)
    out["int8"], _ = run(step, KVCache.init(spec, 1, 16, torch.int8, "cpu"))
    tspec, tparams = load("moe_tight.npz")
    _, fwd = tep.make_ep_forward(tspec, tparams)
    out["tight_fwd"] = fwd(ids).numpy()
    pspec, pparams = load("moe_packed.npz")
    eng = EPEngine(pspec, pparams, ep=2, max_len=16,
                   cache_dtype=torch.float32, device="cpu")
    out["generate"] = eng.generate(prompt, 5)
    r = eng.benchmark_chained(inp["bench"], check=True, warmup=1, reps=1,
                              log=lambda s: None)
    out["bench_ppl"] = r["ppl"]
    out["bench_graph"] = r["graph"]
    np.savez(os.path.join(out_dir, f"ep{rank}.npz"), **out)
    assert cli.main(["dummy", "c4", "--load",
                     os.path.join(out_dir, "moe_packed.npz"), "--benchmark",
                     "12", "--check", "--ep", "2", "--device", "cpu",
                     "--results_log", os.path.join(out_dir, "ppl.txt")]) == 0

elif job == "eptp":
    layout = make_layout(2, 2)
    spec, params = load("moe_attn.npz")
    _, step = tep.make_ep_tp_decode_step(spec, params, layout, fuse=True,
                                         a8=True)
    out["a8"], out["a8_greedy"] = run(
        step, ttp.local_cache(spec, 2, 1, 16, torch.float32, "cpu"),
        greedy=3)
    spec, params = load("moe.npz")
    _, fwd = tep.make_ep_tp_forward(spec, params, layout)
    out["fwd"] = fwd(ids).numpy()
    np.savez(os.path.join(out_dir, f"eptp{rank}.npz"), **out)
    del step, fwd, layout  # their subgroups go before the default group

else:
    raise SystemExit(f"unknown job {job!r}")

dist.destroy_process_group()
print(f"{job.upper()}_OK", flush=True)
