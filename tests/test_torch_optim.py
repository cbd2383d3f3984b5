"""The port's AdamW and schedules (repro_torch.optim) against the reference's
(repro.optim): the reference's optimizer tests ported (the quadratic
converges with f32 and int8 moments, int8 specs, the clip, no decay on 1-D
leaves), the schedules' values against the reference's at the same steps,
and the decay and int8 rules read on the reference's stacked leaf shapes
(the port keeps one tensor a layer, the reference stacks a program entry's
layers, so a block's norm scale is (L, D) there and decayed): rmsnorm scales
(llama3.2), layernorm scale and bias (dbrx), the vision groups' doubly
stacked self-attention leaves (G, 4, ...) and their gates."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import build_model as jax_build  # noqa: E402
from repro.models import get_config as jax_get_config  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import adamw_init_specs as jax_init_specs  # noqa: E402
from repro.optim import constant as jconstant  # noqa: E402
from repro.optim import warmup_cosine as jwarmup_cosine  # noqa: E402
from repro_torch.models import build_model, get_config, reference_shapes  # noqa: E402
from repro_torch.models.layers import ParamSpec  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig,
    adamw_init,
    adamw_init_specs,
    adamw_update,
    constant,
    warmup_cosine,
)


def quadratic_specs():
    return {"w": ParamSpec((8, 64), torch.float32, "normal")}


def run_opt(opt_cfg, steps=60):
    specs = quadratic_specs()
    state_specs = adamw_init_specs(specs, opt_cfg)
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((8, 64), generator=g) * 0.02}
    state = adamw_init(state_specs)
    target = torch.randn((8, 64), generator=torch.Generator().manual_seed(2))

    def loss(p):
        return torch.mean((p["w"] - target) ** 2)

    losses = []
    for _ in range(steps):
        w = params["w"].detach().requires_grad_()
        (gw,) = torch.autograd.grad(loss({"w": w}), [w])
        params, state, _ = adamw_update(params, {"w": gw}, state, state_specs, opt_cfg)
        losses.append(float(loss(params)))
    return losses


def test_adamw_converges_fp32():
    losses = run_opt(AdamWConfig(lr=0.05, weight_decay=0.0))
    assert losses[-1] < 0.05 * losses[0]


def test_adamw_converges_int8_state():
    """8-bit moments (the accessor use case) still optimize the quadratic."""
    losses = run_opt(AdamWConfig(lr=0.05, weight_decay=0.0, int8_state=True, state_block=64))
    assert losses[-1] < 0.1 * losses[0]


def test_int8_state_specs_are_quantized():
    specs = {"w": ParamSpec((4, 128), torch.bfloat16)}
    st = adamw_init_specs(specs, AdamWConfig(int8_state=True, state_block=64))
    assert st["m"]["w"].is_quantized()
    state = adamw_init(st)
    assert state["m"]["w"]["q"].dtype == torch.int8 and state["m"]["w"]["q"].shape == (4, 128)
    assert torch.all(state["m"]["w"]["scale"] == 1.0) and state["m"]["w"]["scale"].shape == (4, 2)
    tiny = {"b": ParamSpec((7,), torch.float32)}  # tiny tensors stay f32
    assert not adamw_init_specs(tiny, AdamWConfig(int8_state=True))["m"]["b"].is_quantized()


def test_grad_clip_and_metrics():
    specs = quadratic_specs()
    st_specs = adamw_init_specs(specs, AdamWConfig())
    params = {"w": torch.randn((8, 64), generator=torch.Generator().manual_seed(0)) * 0.02}
    state = adamw_init(st_specs)
    huge = {"w": torch.full((8, 64), 1e6)}
    p2, s2, m = adamw_update(params, huge, state, st_specs,
                             AdamWConfig(lr=0.1, grad_clip=1.0))
    assert float(m["grad_norm"]) > 1e6
    delta = (p2["w"] - params["w"]).abs()
    assert float(delta.max()) < 0.2 + 0.1 * float(params["w"].abs().max())
    assert int(s2["step"]) == 1


def test_no_weight_decay_on_1d_params():
    specs = {"w": ParamSpec((8, 8), torch.float32, "ones"),
             "scale": ParamSpec((8,), torch.float32, "ones")}
    st_specs = adamw_init_specs(specs, AdamWConfig())
    params = {"w": torch.ones((8, 8)), "scale": torch.ones(8)}
    zero_g = {k: torch.zeros_like(v) for k, v in params.items()}
    opt = AdamWConfig(lr=0.1, weight_decay=0.5, grad_clip=None)
    p2, _, _ = adamw_update(params, zero_g, adamw_init(st_specs), st_specs, opt)
    assert torch.all(p2["w"] < 1.0)  # decayed
    assert torch.all(p2["scale"] == 1.0)  # not decayed


@pytest.mark.parametrize("steps", [(0, 5, 10, 11, 57, 100, 130)])
def test_schedules_match_the_reference(steps):
    for port, ref in ((warmup_cosine(1.0, 10, 100), jwarmup_cosine(1.0, 10, 100)),
                      (warmup_cosine(3e-3, 20, 64, floor=1e-4),
                       jwarmup_cosine(3e-3, 20, 64, floor=1e-4)),
                      (constant(5e-4), jconstant(5e-4))):
        for s in steps:
            got = port(torch.tensor(s, dtype=torch.int32))
            want = ref(jnp.int32(s))
            assert got.dtype == torch.float32
            assert abs(float(got) - float(want)) <= 1e-7 * max(1.0, abs(float(want))), s
    f = warmup_cosine(1.0, warmup_steps=10, total_steps=100)  # the reference's own checks
    assert float(f(torch.tensor(0))) == 0.0
    assert abs(float(f(torch.tensor(10))) - 1.0) < 0.11
    assert float(f(torch.tensor(100))) < 0.01
    assert float(f(torch.tensor(5))) == pytest.approx(0.5, abs=0.01)


def _port_and_reference_state_specs(arch, int8):
    cfg = get_config(arch, smoke=True)
    cfg_j = jax_get_config(arch, smoke=True)
    specs = build_model(cfg, device="cpu").param_specs()
    opt = AdamWConfig(int8_state=int8, state_block=32)
    st = adamw_init_specs(specs, opt, reference_shapes(specs, cfg))
    st_j = jax_init_specs(jax_build(cfg_j).param_specs(), JAdamW(int8_state=int8, state_block=32))
    return cfg, st, jax_build(cfg_j).param_specs(), st_j


def _walk(port, ref_params, ref_moments, path=""):
    """(path, port MomentSpec, reference param spec, reference moment spec)
    for every leaf, the port's first layer of each program entry against the
    reference's stacked leaf."""
    from repro.core.distributed import is_spec

    if is_spec(ref_params):
        yield path, port, ref_params, ref_moments
        return
    if isinstance(ref_params, dict):
        for k in ref_params:
            sub = port[k][0] if isinstance(port[k], list) and k == "self" else port[k]
            yield from _walk(sub, ref_params[k], ref_moments[k], f"{path}/{k}")
        return
    for i, (r, rm) in enumerate(zip(ref_params, ref_moments)):
        sub = port[i][0] if path.endswith("blocks") else port[i]
        yield from _walk(sub, r, rm, f"{path}/{i}")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "dbrx-132b", "llama-3.2-vision-90b"])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_decay_and_int8_rules_follow_the_reference_stacked_shapes(arch, int8):
    cfg, st, ref_params, st_j = _port_and_reference_state_specs(arch, int8)
    seen = set()
    for path, ms, rp, rm in _walk(st["m"], ref_params, st_j["m"]):
        assert ms.ref_shape == tuple(rp.shape), path
        assert ms.decay == (len(rp.shape) >= 2), path  # the reference's ndim >= 2 rule
        assert ms.is_quantized() == rm.is_quantized(), path
        seen.add((path.split("/")[-1], ms.decay))
    if cfg.norm == "rmsnorm":
        assert ("ln_attn", True) in seen  # (L, D) block norm scales are decayed
        assert ("final_norm", False) in seen  # the final norm is not
    else:
        assert ("bias", True) in seen and ("scale", True) in seen  # layernorm, stacked
        assert ("bias", False) in seen  # final_norm's bias
    if cfg.family == "vlm":
        assert ("gate", False) in seen  # (G,): not decayed
        assert any(p.startswith("/blocks/0/self/") for p, *_ in
                   _walk(st["m"], ref_params, st_j["m"]))


def test_int8_rule_reads_the_reference_last_dim():
    """A 0-d leaf stacked to (G,) is not quantized; a (D,) leaf stacked to
    (L, D) is, when D divides into blocks, as in the reference."""
    cfg, st, ref_params, st_j = _port_and_reference_state_specs("llama3.2-1b", True)
    layer = st["m"]["blocks"][0][0]
    assert layer["ln_attn"].ref_shape == (cfg.n_layers, cfg.d_model)
    assert layer["ln_attn"].is_quantized() == (cfg.d_model % 32 == 0)
    assert bool(jax.tree.leaves(st_j["m"]["blocks"][0]["ln_attn"].is_quantized()))
    assert np.all(layer["attn"]["wq"].ref_shape[1:] == layer["attn"]["wq"].shape)
