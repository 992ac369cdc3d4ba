"""Shared by tests/test_torch_demos_*.py: run a CLI of `s2m2_torch.demo` as
`python -m` does, in this process, with the synthesized inputs at a small
size, engines replaced by a tiny seeded one on the CPU, and cv2 and PIL
blocked (an import of either raises ImportError); and run the JAX
package's demo of the same name on the same files and weights, to hold the
two against each other."""
import dataclasses
import os
import runpy
import sys

import numpy as np
import pytest

from s2m2_torch.config import ModelConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ModelConfig(feature_channels=16, num_transformer=1, refine_iter=1)
# the config of the trained checkpoint, on which the Booster mask keeps points
TRAINED = ModelConfig(feature_channels=32, num_transformer=1, refine_iter=2)
TRAINED_CKPT = os.path.join(REPO, "tests", "golden", "trained_c32.npz")
SIZE = (96, 128)  # (H, W) of the synthesized pairs in these tests


def _recording(engine, outputs):
    """`engine`, with what each of its run() calls returns appended to
    `outputs`."""
    run = engine.run

    def recorded(*args, **kwargs):
        outputs.append(run(*args, **kwargs))
        return outputs[-1]

    engine.run = recorded
    return engine


def tiny_engines(monkeypatch, cfg=TINY):
    """Replace StereoEngine with one that builds `cfg` at the precision, on
    the device and from the checkpoint the CLI asks for; returns the list of
    the CLI's requests: (model type, keyword arguments, what each run()
    returned)."""
    import s2m2_torch.runtime.engine as engine_mod
    from s2m2_torch.demo import _scenes
    real = engine_mod.StereoEngine
    requests = []

    def factory(model_type="S", **kwargs):
        requests.append((model_type, kwargs, []))
        return _recording(real(cfg, checkpoint=kwargs.get("checkpoint"),
                               precision=kwargs.get("precision", "bf16"),
                               device=kwargs.get("device", "cuda")), requests[-1][2])

    monkeypatch.setattr(engine_mod, "StereoEngine", factory)
    monkeypatch.setattr(_scenes, "SIZE", SIZE)
    return requests


def run_cli(name, argv, monkeypatch, block=("cv2", "PIL")):
    """Exit code of `python -m s2m2_torch.demo.<name> argv`, run here."""
    for module in block:
        monkeypatch.setitem(sys.modules, module, None)
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    with pytest.raises(SystemExit) as exc:
        runpy.run_module(f"s2m2_torch.demo.{name}", run_name="__main__", alter_sys=True)
    return exc.value.code


def run_jax_demo(script, argv, monkeypatch, cfg=TINY):
    """Run the JAX package's `demo/<script>` with `argv` on an engine of
    `cfg` (the checkpoint and precision the demo asks for), as
    tests/test_demos.py does; returns what each run() returned."""
    import s2m2_tpu.runtime.engine as engine_mod
    from s2m2_tpu.config import ModelConfig as JaxConfig
    real = engine_mod.StereoEngine
    outputs = []
    jax_cfg = JaxConfig(**dataclasses.asdict(cfg))
    monkeypatch.setattr(engine_mod, "StereoEngine", lambda model_type, **kw: _recording(
        real(jax_cfg, checkpoint=kw.get("checkpoint"), precision=kw["precision"]), outputs))
    monkeypatch.setattr(sys, "argv", [script] + list(argv))
    runpy.run_path(os.path.join(REPO, "demo", script), run_name="__main__")
    return outputs


def assert_same_runs(port, jax):
    """The port's run() results equal the JAX demo's within fp32 rounding:
    disparity, occlusion, confidence and the confidence score."""
    assert len(port) == len(jax) == 1
    for name, got, want in zip(("disp", "occ", "conf"), port[0][:3], jax[0][:3]):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-4,
                                   err_msg=name)
    assert abs(port[0][3] - jax[0][3]) < 1e-5


def read_ply(path):
    """(points (N, 3) float, colours (N, 3) uint8) of an ASCII PLY file that
    `utils.pointcloud.save_ply` writes."""
    with open(path) as f:
        header = [next(f) for _ in range(10)]
        assert header[0] == "ply\n" and header[-1] == "end_header\n", header
        n = int(header[2].split()[-1])
        rows = np.loadtxt(f, ndmin=2).reshape(n, 6)
    return rows[:, :3], rows[:, 3:].astype(np.uint8)


def assert_same_clouds(port_ply, jax_ply):
    """The same points (to the file's 5 decimals and fp32 rounding) with
    the same colours; returns the number of points."""
    (pts, cols), (want_pts, want_cols) = read_ply(port_ply), read_ply(jax_ply)
    assert pts.shape == want_pts.shape
    np.testing.assert_allclose(pts, want_pts, rtol=1e-4, atol=2e-5)
    np.testing.assert_array_equal(cols, want_cols)
    return len(pts)
