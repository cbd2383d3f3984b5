"""The port's distribution layer across ranks: 4 gloo processes on the CPU.

One group of 4 ranks (``torch.set_num_threads(1)`` each, a ``file://``
rendezvous under the module's temporary directory) runs every case of
``CASES``, and each case is its own test here. The group's join waits 120 s
at most; a group that hangs fails its tests, not the suite's clock. The
cases: the committed card probe (``scripts/probe_card_ranks.py``'s checks),
``Sharder`` round trips, the vocab-parallel ``cross_entropy`` and the
vocab-parallel embedding against the unsharded ones, the global grad norm of
``clip_by_global_norm`` on DTensor grads, self-attention with kv_heads that
do not divide the model axis (the Megatron fallback: KV replicated, Q
sharded) and with kv_heads that do, the DTensor guard of the kernel
wrappers, the sharded step built for every family with f32 and int8
moments and its one refusal (an int8 quant block split by a shard), the
DTensor dispatches a layer of the block-mapped forward (``DispatchCounter``:
within the block's leaves plus a constant), and expert-parallel MoE (kimi
smoke, f32) on a (2, 2) mesh against
the port's einsum path at capacity factor 8 and, through the ranks' saved
outputs and gradients, against the reference's ``apply_moe_ep`` run once in
a JAX subprocess with 4 host devices on the same numpy weights and input, at
capacity factor 8 and at the config's own 1.25 (with drops). Outputs within
2e-4 and gradients within 5e-3 (the reference's own tolerances,
``tests/test_multidevice.py:44-46``); the unsharded comparisons within
1e-5 (values) and 1e-5 of each gradient's max-abs.

``spawn_group`` is the harness the other multi-rank files use.
"""
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
JOIN_S = 120


# ---------------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------------
def spawn_group(script: str, workdir: Path, world: int = WORLD, extra=(), timeout=JOIN_S,
                side=None, meanwhile=None):
    """Run ``script --rank r --world W --dir workdir`` in ``world`` processes
    (and ``side``, an argv list, beside them; ``meanwhile()`` here while they
    run) -> {case: {"ok", "detail"}} merged over the ranks (a case passes
    when it passed on every rank), plus "_exit" (the exit codes), "_side"
    (the side process's exit and output) and "_meanwhile" (what
    ``meanwhile`` returned). Processes still running at ``timeout`` are
    killed."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                                                       os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1")
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, script, "--rank", str(r), "--world", str(world),
                               "--dir", str(workdir), *extra], env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(world)]
    side_proc = None
    if side is not None:
        side_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                        JAX_PLATFORMS="cpu")
        side_proc = subprocess.Popen(side, env=side_env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + timeout
    done = meanwhile() if meanwhile is not None else None
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(deadline - time.monotonic(), 1)))
        except subprocess.TimeoutExpired:
            codes.append("timeout")
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in logs:
        f.close()
    merged = {"_exit": codes, "_meanwhile": done}
    for r in range(world):
        path = workdir / f"results{r}.json"
        res = json.loads(path.read_text()) if path.exists() else {}
        for case, rec in res.items():
            m = merged.setdefault(case, {"ok": True, "detail": []})
            m["ok"] &= rec["ok"]
            if not rec["ok"]:
                m["detail"].append(f"rank {r}: {rec['detail']}")
    if side_proc is not None:
        try:
            out, _ = side_proc.communicate(timeout=max(deadline - time.monotonic(), 1) + 60)
        except subprocess.TimeoutExpired:
            side_proc.kill()
            out, _ = side_proc.communicate()
        merged["_side"] = {"exit": side_proc.returncode, "output": out[-3000:]}
    return merged


def check_case(results, case, workdir):
    rec = results.get(case)
    if rec is None:
        tails = {r: (workdir / f"rank{r}.log").read_text()[-1500:]
                 for r in range(WORLD) if (workdir / f"rank{r}.log").exists()}
        pytest.fail(f"case {case} did not run (exit codes {results['_exit']}): {tails}")
    assert rec["ok"], rec["detail"]


def rank_main(cases, argv=None):
    """A rank's entry: join the group, run every case in order (each in its
    own try), write results<rank>.json, leave."""
    import argparse

    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--dir")
    args, _ = ap.parse_known_args(argv)
    torch.set_num_threads(1)
    workdir = Path(args.dir)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'store'}",
                            world_size=args.world, rank=args.rank)
    out = {}
    for name, fn in cases.items():
        try:
            fn(args.rank, workdir)
            out[name] = {"ok": True, "detail": ""}
        except Exception:
            out[name] = {"ok": False, "detail": traceback.format_exc()[-2000:]}
        (workdir / f"results{args.rank}.json").write_text(json.dumps(out))
    if dist.is_initialized():  # a rank an elastic re-mesh dropped has none
        dist.destroy_process_group()


def mesh_of(shape):
    from repro_torch.launch.mesh import _mesh

    return _mesh(shape, ("data", "model"), "cpu")


def rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


# ---------------------------------------------------------------------------------
# the cases (run in every rank)
# ---------------------------------------------------------------------------------
def case_probe(rank, workdir):
    sys.path.insert(0, str(ROOT / "scripts"))
    import probe_card_ranks

    res = probe_card_ranks.checks(rank, WORLD, "cpu")
    assert not any(res.values()), res


def case_sharder_round_trips(rank, workdir):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.core.distributed import distribute
    from repro_torch.launch import train_rules
    from repro_torch.models import get_config
    from repro_torch.models.layers import NULL_SHARDER, Sharder

    mesh = mesh_of((2, 2))
    rules = train_rules(get_config("llama3.2-1b", smoke=True))
    shard = Sharder(mesh, rules)
    x = torch.randn(4, 6, 8, 3, generator=torch.Generator().manual_seed(0))
    assert shard(x, "batch", "heads", "seq", None) is x  # a plain tensor passes unchanged
    assert NULL_SHARDER(x, "batch") is x
    d = distribute(x, mesh, [Replicate(), Replicate()])
    for axes, want in ((("batch", "heads", "seq", None), [Shard(0), Shard(1)]),
                       (("batch", "seq", "heads", None), [Shard(0), Shard(2)]),
                       ((None, "heads", None, "vocab"), [Replicate(), Shard(1)]),
                       ((None, None, "ffn", None), [Replicate(), Shard(2)]),
                       (("batch", None, None, "heads"), [Shard(0), Replicate()])):  # 3 heads
        y = shard(d, *axes)
        assert list(y.placements) == want, (axes, y.placements)
        assert torch.equal(y.full_tensor(), x)
        assert torch.equal(shard(y, None, None, None, None).full_tensor(), x)
        d = y


def case_vocab_parallel_loss(rank, workdir):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.core.distributed import distribute
    from repro_torch.models.layers import cross_entropy

    mesh = mesh_of((2, 2))
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(4, 5, 64, generator=g) * 3
    labels = torch.randint(0, 64, (4, 5), generator=g)
    mask = (torch.rand(4, 5, generator=g) > 0.3).float()
    for pl in ([Shard(0), Shard(2)], [Replicate(), Shard(2)], [Shard(0), Replicate()],
               [Shard(2), Shard(0)]):
        for m in (None, mask):
            ref = logits.clone().requires_grad_()
            want = cross_entropy(ref, labels, m)
            want.backward()
            d = distribute(logits, mesh, pl).requires_grad_()
            lab = distribute(labels, mesh, [p if isinstance(p, Shard) and p.dim == 0
                                            else Replicate() for p in pl])
            md = None if m is None else distribute(m, mesh, lab.placements)
            from torch.distributed.tensor.experimental import implicit_replication
            with implicit_replication():
                got = cross_entropy(d, lab, md)
                got.backward()
            assert abs(float(got.full_tensor()) - float(want)) <= 1e-5 * abs(float(want)), pl
            assert rel(d.grad.full_tensor(), ref.grad) <= 1e-5, pl


def case_vocab_parallel_embedding(rank, workdir):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.core.distributed import distribute
    from repro_torch.models.layers import apply_embed

    mesh = mesh_of((2, 2))
    g = torch.Generator().manual_seed(2)
    table = torch.randn(32, 8, generator=g)
    tokens = torch.randint(0, 32, (4, 6), generator=g)
    r = torch.randn(4, 6, 8, generator=g)
    ref = table.clone().requires_grad_()
    (apply_embed({"embedding": ref}, tokens) * r).sum().backward()
    for tpl in ([Shard(1), Shard(0)], [Replicate(), Shard(0)], [Shard(0), Replicate()]):
        tab = distribute(table, mesh, tpl).requires_grad_()
        tok = distribute(tokens, mesh, [Shard(0), Replicate()])
        out = apply_embed({"embedding": tab}, tok)
        assert torch.equal(out.full_tensor(), table[tokens]), tpl
        (out * distribute(r, mesh, out.placements)).sum().backward()
        assert rel(tab.grad.full_tensor(), ref.grad) <= 1e-6, tpl


def case_global_grad_norm(rank, workdir):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.distributed import distribute
    from repro_torch.optim import clip_by_global_norm

    mesh = mesh_of((2, 2))
    g = torch.Generator().manual_seed(3)
    full = {"a": torch.randn(8, 6, generator=g), "b": [torch.randn(4, generator=g),
                                                       torch.randn(2, 4, 6, generator=g)]}
    pls = {"a": [Shard(0), Shard(1)], "b": [[Replicate(), Shard(0)], [Replicate(), Replicate()]]}
    dt = {"a": distribute(full["a"], mesh, pls["a"]),
          "b": [distribute(full["b"][0], mesh, pls["b"][0]),
                distribute(full["b"][1], mesh, pls["b"][1])]}
    for max_norm in (1.0, 1e3):
        want_g, want_n = clip_by_global_norm(full, max_norm)
        with implicit_replication():
            got_g, got_n = clip_by_global_norm(dt, max_norm)
        got_n = got_n.full_tensor() if hasattr(got_n, "full_tensor") else got_n
        assert abs(float(got_n) - float(want_n)) <= 1e-6 * float(want_n), (got_n, want_n)
        local = torch.sqrt(sum(torch.sum(t.to_local() ** 2) for t in (dt["a"], *dt["b"])))
        assert abs(float(local) - float(want_n)) > 1e-3  # a shard's norm is not the norm
        assert rel(got_g["a"].full_tensor(), want_g["a"]) <= 1e-6
        assert rel(got_g["b"][1].full_tensor(), want_g["b"][1]) <= 1e-6


def _attention_case(shape, arch):
    import dataclasses

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.distributed import distribute, tree_distribute
    from repro_torch.launch import train_rules
    from repro_torch.models import get_config
    from repro_torch.models.attention import attn_specs, self_attention
    from repro_torch.models.layers import Sharder, init_tree

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    mesh = mesh_of(shape)
    rules = train_rules(cfg)
    specs = attn_specs(cfg)
    p = init_tree(specs, torch.Generator().manual_seed(4), "cpu")
    x = torch.randn(4, 12, cfg.d_model, generator=torch.Generator().manual_seed(5))
    r = torch.randn(4, 12, cfg.d_model, generator=torch.Generator().manual_seed(6))
    pr = {k: v.clone().requires_grad_() for k, v in p.items()}
    xr = x.clone().requires_grad_()
    want = self_attention(cfg, pr, xr)
    (want * r).sum().backward()
    shard = Sharder(mesh, rules)
    pd = {k: v.requires_grad_() for k, v in tree_distribute(p, specs, mesh, rules).items()}
    pl = rules.placements(("batch", "seq", None), x.shape, mesh)
    xd = distribute(x, mesh, pl).requires_grad_()
    with implicit_replication():
        got = self_attention(cfg, pd, xd, shard=shard)
        (got * distribute(r, mesh, got.placements)).sum().backward()
    assert rel(got.full_tensor(), want) <= 1e-5
    assert rel(xd.grad.full_tensor(), xr.grad) <= 1e-5
    for k in p:
        assert rel(pd[k].grad.full_tensor(), pr[k].grad) <= 1e-5, k
    return pd


def case_attention_megatron_fallback(rank, workdir):
    """dbrx smoke: 4 q heads, 2 kv heads on a model axis of 4: wk / wv are
    replicated (kv_heads does not divide), wq sharded; each rank's one q head
    takes kv head rank // 2."""
    from torch.distributed.tensor import Replicate, Shard

    pd = _attention_case((1, 4), "dbrx-132b")
    assert pd["wq"].placements[1] == Shard(1) and pd["wk"].placements[1] == Replicate()


def case_attention_kv_heads_divide(rank, workdir):
    from torch.distributed.tensor import Shard

    pd = _attention_case((2, 2), "llama3.2-1b")
    assert pd["wk"].placements[1] == Shard(1)


def case_kernel_wrappers_refuse_dtensors(rank, workdir):
    from torch.distributed.tensor import Replicate

    from repro_torch.core.distributed import distribute
    from repro_torch.kernels import flash_attention, ssd_scan
    from repro_torch.kernels.common import no_dtensor, no_grad_through

    mesh = mesh_of((2, 2))
    d = distribute(torch.zeros(2, 2, 4, 8), mesh, [Replicate(), Replicate()])
    for call in (lambda: no_dtensor("k", torch.zeros(1), d),
                 lambda: no_grad_through("k", d),
                 lambda: flash_attention.flash_attention(d, d, d),
                 lambda: ssd_scan._check("x", d, d.shape, d.dtype, d.device)):
        try:
            call()
        except TypeError as e:
            assert "local_map" in str(e), e
        else:
            raise AssertionError("a DTensor passed a kernel wrapper's guard")


MOE_CFS = (8.0, 1.25)


def moe_inputs(path: Path):
    """kimi smoke's MoE at f32: numpy weights, input and output cotangent."""
    rng = np.random.default_rng(7)
    d, e, f = 64, 8, 32
    arrs = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
            "w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
            "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
            "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f),
            "x": rng.standard_normal((8, 16, d)), "r": rng.standard_normal((8, 16, d))}
    np.savez(path, **{k: v.astype(np.float32) for k, v in arrs.items()})


def case_moe_expert_parallel(rank, workdir):
    import dataclasses

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.distributed import distribute, tree_distribute
    from repro_torch.launch import train_rules
    from repro_torch.models import get_config
    from repro_torch.models.layers import Sharder
    from repro_torch.models.moe import apply_moe, apply_moe_ep, moe_specs, use_shard_map

    mesh = mesh_of((2, 2))
    arrs = dict(np.load(workdir / "moe_inputs.npz"))
    x, r = torch.from_numpy(arrs.pop("x")), torch.from_numpy(arrs.pop("r"))
    p = {k: torch.from_numpy(v) for k, v in arrs.items()}
    saved = {}
    for cf in MOE_CFS:
        cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b", smoke=True), dtype="float32",
                                  capacity_factor=cf)
        rules = train_rules(cfg)
        shard = Sharder(mesh, rules)
        assert use_shard_map(shard)
        pd = {k: v.requires_grad_() for k, v in
              tree_distribute(p, moe_specs(cfg), mesh, rules).items()}
        xd = distribute(x, mesh, rules.placements(("batch", "seq", None), x.shape, mesh))
        xd.requires_grad_()
        with implicit_replication():
            y, aux = apply_moe_ep(cfg, pd, xd, shard)
            ((y * distribute(r, mesh, y.placements)).sum() + aux).backward()
        rec = {"y": y.full_tensor(), "aux": aux.full_tensor(), "x": xd.grad.full_tensor(),
               **{k: v.grad.full_tensor() for k, v in pd.items()}}
        saved[cf] = {k: v.detach().numpy() for k, v in rec.items()}
        if cf == 8.0:  # no drops: the einsum path's function
            pr = {k: v.clone().requires_grad_() for k, v in p.items()}
            xr = x.clone().requires_grad_()
            yr, _ = apply_moe(cfg, pr, xr)
            (yr * r).sum().backward()
            pd2 = {k: v.detach().requires_grad_() for k, v in pd.items()}
            xd2 = xd.detach().requires_grad_()
            with implicit_replication():
                y2, _ = apply_moe_ep(cfg, pd2, xd2, shard)
                (y2 * distribute(r, mesh, y2.placements)).sum().backward()
            assert rel(y2.full_tensor(), yr) <= 2e-4
            assert rel(xd2.grad.full_tensor(), xr.grad) <= 5e-3
            for k in pr:
                assert rel(pd2[k].grad.full_tensor(), pr[k].grad) <= 5e-3, k
    if rank == 0:
        np.savez(workdir / "moe_port.npz", **{f"{cf}/{k}": v for cf, rec in saved.items()
                                              for k, v in rec.items()})


def case_collective_counter(rank, workdir):
    """The counter sees a process-group all_reduce, a DTensor all-gather
    and the backward's collectives, with their input bytes."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.core.distributed import CollectiveCounter, distribute, group_sum

    mesh = mesh_of((2, 2))
    x = torch.ones(8, 4)
    with CollectiveCounter() as c:
        y = x.clone()
        dist.all_reduce(y)
        d = distribute(x, mesh, [Shard(0), Replicate()])
        d.redistribute(mesh, [Replicate(), Replicate()])
    assert torch.equal(y, x * 4)
    assert c.calls.get("allreduce_") == 1 and c.bytes["allreduce_"] == 8 * 4 * 4, c.calls
    gathers = {k: v for k, v in c.bytes.items() if "gather" in k}
    assert sum(gathers.values()) == 4 * 4 * 4, c.bytes  # the 4 x 4 f32 shard
    z = x.clone().requires_grad_()
    with CollectiveCounter() as c:
        group_sum(z, [mesh.get_group(1)]).sum().backward()
    assert c.calls == {"allreduce_": 1}, c.calls  # the backward passes through
    assert torch.equal(z.grad, torch.ones_like(x))


FAMILY_ARCHS = ("llama3.2-1b", "dbrx-132b", "mamba2-780m", "recurrentgemma-2b",
                "whisper-large-v3", "llama-3.2-vision-90b")


def case_refusals(rank, workdir):
    """On (2, 2) and (4, 1) every family builds a sharded step, with f32
    moments and with int8 ones (quant block 16); the one refusal left is an
    int8 moment whose quant block a shard would split: at the default block
    of 64, llama smoke's embedding (512, 64) has its embed dim split over
    "data" to 32 or 16 columns, and the step names that leaf."""
    from repro_torch.launch import train_rules
    from repro_torch.models import build_model, get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step

    for shape in ((2, 2), (4, 1)):
        mesh = mesh_of(shape)
        for arch in FAMILY_ARCHS:
            cfg = get_config(arch, smoke=True)
            for opt in (AdamWConfig(), AdamWConfig(int8_state=True, state_block=16)):
                make_train_step(build_model(cfg, device="cpu"), opt, mesh=mesh,
                                rules=train_rules(cfg))
        cfg = get_config("llama3.2-1b", smoke=True)
        try:
            make_train_step(build_model(cfg, device="cpu"), AdamWConfig(int8_state=True),
                            mesh=mesh, rules=train_rules(cfg))
        except NotImplementedError as e:
            assert "embed/embedding" in str(e) and "quant block 64" in str(e), e
        else:
            raise AssertionError(f"int8 moments split by a shard built a step on {shape}")


DISPATCH_SLACK = 4  # redistributions and DTensor ops a layer beyond its leaves


def case_dispatch_count(rank, workdir):
    """One forward of llama smoke on (2, 2), at 2 and at 4 layers: the
    redistributions and the DTensor op dispatches a layer (the difference
    over the 2 extra layers) stay within the block's parameter leaves plus
    DISPATCH_SLACK: the FSDP gather of each leaf at the block map's entry,
    and nothing a block runs op by op on DTensors. The Sharder lays
    activations out only at the embedding's output and at the logits."""
    import dataclasses

    from repro_torch.core.distributed import DispatchCounter, tree_distribute
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import train_rules
    from repro_torch.models import build_model, get_config
    from repro_torch.models.layers import Sharder
    from repro_torch.train.step import on_mesh, place_batch

    mesh = mesh_of((2, 2))
    counts, sharder_calls = {}, {}
    original = Sharder.__call__
    for layers in (2, 4):
        cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True), dtype="float32",
                                  n_layers=layers)
        model = build_model(cfg, device="cpu")
        rules = train_rules(cfg)
        shard = Sharder(mesh, rules)
        params = tree_distribute(model.init_params(torch.Generator().manual_seed(0)),
                                 model.param_specs(), mesh, rules)
        batch = place_batch({"tokens": torch.randint(0, cfg.vocab, (4, 17),
                                                     generator=torch.Generator().manual_seed(1))},
                            mesh, rules)
        calls = []

        def counted(self, *a, **kw):
            calls.append(None)
            return original(self, *a, **kw)

        Sharder.__call__ = counted
        try:
            with torch.no_grad(), on_mesh(shard), DispatchCounter() as c:
                model.loss_fn(params, batch, shard=shard)
        finally:
            Sharder.__call__ = original
        counts[layers] = (c.redistributions, c.dtensor_ops)
        sharder_calls[layers] = len(calls)
        leaves = len(tree_leaves(params["blocks"][0][0]))
    redist, ops = ((counts[4][i] - counts[2][i]) / 2 for i in range(2))
    assert redist + ops <= leaves + DISPATCH_SLACK, (counts, leaves)
    assert sharder_calls == {2: 2, 4: 2}, sharder_calls


CASES = {"probe": case_probe, "sharder_round_trips": case_sharder_round_trips,
         "vocab_parallel_loss": case_vocab_parallel_loss,
         "vocab_parallel_embedding": case_vocab_parallel_embedding,
         "global_grad_norm": case_global_grad_norm,
         "attention_megatron_fallback": case_attention_megatron_fallback,
         "attention_kv_heads_divide": case_attention_kv_heads_divide,
         "kernel_wrappers_refuse_dtensors": case_kernel_wrappers_refuse_dtensors,
         "moe_expert_parallel": case_moe_expert_parallel, "refusals": case_refusals,
         "collective_counter": case_collective_counter, "dispatch_count": case_dispatch_count}

JAX_MOE = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.launch.sharding import train_rules
from repro.models import get_config
from repro.models.layers import Sharder
from repro.models.moe import apply_moe_ep
d = sys.argv[1]
arrs = dict(np.load(d + "/moe_inputs.npz"))
x, r = jnp.asarray(arrs.pop("x")), jnp.asarray(arrs.pop("r"))
p = {k: jnp.asarray(v) for k, v in arrs.items()}
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {}
for cf in (8.0, 1.25):
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b", smoke=True), dtype="float32",
                              capacity_factor=cf)
    shard = Sharder(mesh, train_rules(cfg))
    def loss(p, x):
        y, aux = apply_moe_ep(cfg, p, x, shard)
        return jnp.sum(y * r) + aux, (y, aux)
    with mesh:
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                           has_aux=True))(p, x)
    out.update({f"{cf}/y": y, f"{cf}/aux": aux, f"{cf}/x": gx,
                **{f"{cf}/{k}": v for k, v in gp.items()}})
np.savez(d + "/moe_jax.npz", **{k: np.asarray(v) for k, v in out.items()})
print("JAX-EP-OK")
"""


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("multirank")
    moe_inputs(workdir / "moe_inputs.npz")
    side = [sys.executable, "-c", JAX_MOE, str(workdir)]
    return spawn_group(__file__, workdir, side=side), workdir


@pytest.mark.parametrize("case", list(CASES))
def test_case_across_ranks(group, case):
    results, workdir = group
    check_case(results, case, workdir)


@pytest.mark.parametrize("cf", MOE_CFS)
def test_expert_parallel_moe_equals_the_references(group, cf):
    """The port's EP MoE (outputs, aux, the gradients of sum(y * r) + aux)
    against the reference's ``apply_moe_ep`` on a (2, 2) mesh of 4 host
    devices, on the same numpy weights: at cf 8 and at kimi smoke's own 1.25,
    where both drop entries past the per-shard capacity alike."""
    results, workdir = group
    side = results.get("_side", {})
    assert side.get("exit") == 0, side.get("output")
    check_case(results, "moe_expert_parallel", workdir)
    port, ref = np.load(workdir / "moe_port.npz"), np.load(workdir / "moe_jax.npz")
    for k in ("y", "aux"):
        np.testing.assert_allclose(port[f"{cf}/{k}"], ref[f"{cf}/{k}"], rtol=2e-4, atol=2e-4)
    for k in ("x", "router", "w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(port[f"{cf}/{k}"], ref[f"{cf}/{k}"], rtol=5e-3, atol=5e-3,
                                   err_msg=k)


if __name__ == "__main__":
    rank_main(CASES)
