"""The port's int8 engine with each of the JAX package's opt-ins against the
JAX package's int8 forward with the same opt-in, on the golden fixture
s2m2_c32_ntr1.npz in float32 (weights and images): the JAX observe pass's
scales loaded into the port, mean |disp - disp_jax| < 0.01 px. In float32
both packages keep the correlation in float32 before the OT, so the
comparison does not depend on JAX's matcher route (ROADMAP Queue 3 item
2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2m2_torch.models import quant

from tests.test_torch_int8_engine import FIXTURES, _jax_model, _port_model

torch.set_num_threads(2)
FLAGS = {"int8_attn": "set_int8_attn", "int8_acc_bf16": "set_acc_bf16"}
OPTINS = {"int8_attn": {"attn": True}, "int8_acc_bf16": {"acc_bf16": True}}


def _jax_int8(optin):
    """(scales, disparity) of the JAX package's int8 path with `optin` on."""
    from s2m2_tpu.models import quant as jq
    from s2m2_tpu.models.s2m2 import forward
    jcfg, params, ja, jb = _jax_model(FIXTURES[0], bf16=False)

    def observer(p, a, b):
        with jq.observe() as obs:
            forward(p, a, b, jcfg)
        return jnp.stack(obs)

    # XLA's optimizations off: a third of the compile time on the CPU
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    getattr(jq, FLAGS[optin])(True)
    try:
        amax = np.asarray(jax.jit(observer)(params, ja, jb), np.float32)
        scales = tuple(float(v) / 127.0 for v in amax)
        with jq.quantized(scales):
            disp = jax.jit(lambda p, a, b: forward(p, a, b, jcfg)[0])(params, ja, jb)
    finally:
        getattr(jq, FLAGS[optin])(False)
        jax.config.update("jax_disable_most_optimizations", prev)
    return scales, np.asarray(disp, np.float32)


@pytest.mark.parametrize("optin", list(OPTINS))
def test_optin_disparity_matches_jax_with_its_scales(optin):
    scales, want = _jax_int8(optin)
    model, a, b = _port_model(FIXTURES[0], bf16=False)
    with torch.inference_mode(), quant.quantized(scales, **OPTINS[optin]):
        got = model(a, b)[0].numpy()
    assert (sum(r["kind"] == "attention" for r in quant.last_log()) > 0) == \
        (optin == "int8_attn")
    delta = np.abs(got - want).mean()
    assert delta < 0.01, f"port vs JAX int8 ({optin}) disparity {delta}"
