"""The int8 drift readings of the golden fixtures, the port beside the JAX
package: mean |disp - fp32 reference| in px of an int8 engine calibrated
on the pair it serves, plain and with each opt-in (int8_attn,
int8_acc_bf16), on the fixture's pair and on the four 1e-6 relative
changes of it (one image times 1 + 1e-6 or 1 - 1e-6, each in turn). The
port's readings are the ones tests/test_torch_int8_optins.py bounds; JAX's
are taken as tests/test_quant.py:186-218 takes them, on its fused-OT route
(the Pallas kernel in interpret mode, cv kept in float32, the numerics the
port follows), and on the pair alone also on its default route (cv rounded
to bf16 before the Sinkhorn); ROADMAP Queue 3 items 2 and 9. On the CPU,
about 6 minutes:

    JAX_PLATFORMS=cpu python -m tests.torch_int8_drift_readings
"""
import functools
import json
import os

import jax
import numpy as np
import torch

from s2m2_torch.runtime.engine import StereoEngine

from tests.test_torch_int8_engine import FIXTURES, GOLDEN, _fixture

OPTINS = (None, "int8_attn", "int8_acc_bf16")


UP, DOWN = np.float32(1 + 1e-6), np.float32(1 - 1e-6)
CHANGES = ((1, 1), (UP, 1), (DOWN, 1), (1, UP), (1, DOWN))  # the pair first


def port_reading(fixture, optin, change=(1, 1)):
    cfg, img0, img1, ref = _fixture(fixture)
    eng = StereoEngine(cfg, checkpoint=os.path.join(GOLDEN, fixture), precision="int8",
                       device="cpu", **({optin: True} if optin else {}))
    disp = eng.forward_padded(img0 * change[0], img1 * change[1])[0].numpy()  # calibrates
    return float(np.abs(disp - ref).mean())


def jax_reading(fixture, optin, fused_ot, change=(1, 1)):
    from s2m2_tpu.models import matching
    from s2m2_tpu.models import quant as q
    from s2m2_tpu.models.s2m2 import forward
    from s2m2_tpu.ops.sinkhorn import fused_correlation_ot

    from tests.test_quant import _load_golden_for_drift

    class _Backend:  # the fused route's backend check, passed on the CPU
        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def default_backend():
            return "interpret"

    cfg, params, a, b, ref = _load_golden_for_drift(fixture)
    if change != (1, 1):  # the change of the float32 image, then bf16 as the test casts
        import jax.numpy as jnp

        from tests.test_torch_int8_engine import _fixture as fixture_images
        _, img0, img1, _ = fixture_images(fixture)
        a, b = (jnp.asarray(x * c, jnp.bfloat16) for x, c in zip((img0, img1), change))
    saved = matching.jax, matching.fused_correlation_ot
    if fused_ot:
        matching.jax = _Backend()
        matching.fused_correlation_ot = functools.partial(fused_correlation_ot, interpret=True)
    matching.set_use_fused_ot(fused_ot)
    q.set_int8_attn(optin == "int8_attn")
    q.set_acc_bf16(optin == "int8_acc_bf16")
    try:
        with q.observe(skip_fp32=True) as obs:
            forward(params, a, b, cfg)
        scales = tuple(float(o) / 127.0 for o in obs)
        with q.quantized(scales, skip_fp32=True):
            disp = forward(params, a, b, cfg)[0]
    finally:
        q.set_int8_attn(False)
        q.set_acc_bf16(False)
        matching.set_use_fused_ot(False)
        matching.jax, matching.fused_correlation_ot = saved
    return float(np.abs(np.asarray(disp, np.float32) - ref).mean())


def main():
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)
    for fixture in FIXTURES:
        for optin in OPTINS:
            port = [port_reading(fixture, optin, c) for c in CHANGES]
            fused = [jax_reading(fixture, optin, True, c) for c in CHANGES]
            print(json.dumps({
                "fixture": fixture, "optin": optin or "none",
                "port_pair": port[0], "port_mean": float(np.mean(port)), "port_runs": port,
                "jax_default_route_pair": jax_reading(fixture, optin, False),
                "jax_fused_ot_pair": fused[0], "jax_fused_ot_mean": float(np.mean(fused)),
                "jax_fused_ot_runs": fused}), flush=True)


if __name__ == "__main__":
    main()
