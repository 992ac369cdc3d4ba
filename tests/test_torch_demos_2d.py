"""The port's 2D demo CLI end to end on the CPU at its synthesized default
input (a small size, a tiny engine), in fp32 and in int8, with
neither cv2 nor PIL importable, and held against the JAX package's demo on
the same files; and every demo's default device, the card, refused here
rather than replaced by the CPU."""
import numpy as np
import pytest
import torch

from s2m2_torch.utils.png import read_png
from tests.torch_demos import SIZE, assert_same_runs, run_cli, run_jax_demo, tiny_engines

torch.set_num_threads(2)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_2d_demo_defaults(tmp_path, monkeypatch, capsys, caplog, precision):
    requests = tiny_engines(monkeypatch)
    out = tmp_path / "result.png"
    assert run_cli("visualize_2d_simple", ["--precision", precision, "--n_repeat", "2",
                                           "--out", str(out), "--device", "cpu"],
                   monkeypatch) == 0
    assert [r.getMessage() for r in caplog.records
            if "wrote the synthesized 2d inputs" in r.getMessage()]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("confidence score: ")
    assert lines[1].startswith("runtime: ") and "FPS" in lines[1]
    assert lines[2].startswith("disparity range: [")
    assert lines[3] == f"saved {out}"
    model_type, kwargs, _ = requests[0]
    assert model_type == "S" and kwargs["precision"] == precision
    assert kwargs["refine_iter"] == 3 and kwargs["use_positivity"]
    panel = read_png(out)
    h, w = SIZE
    assert panel.shape == (h, 3 * w, 3)
    # the left third is the synthesized left image (the panel is stored RGB)
    from s2m2_torch.demo._scenes import scene_pair
    np.testing.assert_array_equal(panel[:, :w], scene_pair(h, w)[0])


def test_2d_demo_equals_jax(tmp_path, monkeypatch):
    """The port's CLI at its defaults and demo/visualize_2d_simple.py given
    the same synthesized files and seeded weights: the same disparity,
    occlusion and confidence in fp32, and the same panel but where a
    disparity within rounding of a colour step takes the next colour."""
    from s2m2_torch.demo import _scenes
    requests = tiny_engines(monkeypatch)
    files = _scenes.write_defaults("2d", str(tmp_path))
    jax_png, port_png = tmp_path / "jax.png", tmp_path / "port.png"
    jax = run_jax_demo("visualize_2d_simple.py",
                       ["--left_path", files["im0.png"], "--right_path", files["im1.png"],
                        "--precision", "fp32", "--n_repeat", "1", "--out", str(jax_png)],
                       monkeypatch)
    assert run_cli("visualize_2d_simple", ["--precision", "fp32", "--n_repeat", "1",
                                           "--out", str(port_png), "--device", "cpu"],
                   monkeypatch) == 0
    assert_same_runs(requests[0][2], jax)
    got, want = read_png(port_png), read_png(jax_png)
    assert got.shape == want.shape == (SIZE[0], 3 * SIZE[1], 3)
    differ = (got != want).any(-1)
    assert differ.mean() < 1e-3 and np.abs(got.astype(int) - want).max() <= 8


@pytest.mark.parametrize("name,argv", [
    ("visualize_2d_simple", []), ("visualize_3d_middlebury", []),
    ("visualize_3d_booster", []), ("online_calibration", ["--method", "cem"]),
    ("train_demo", ["--steps", "1"])])
def test_demos_default_to_the_card(tmp_path, monkeypatch, name, argv):
    """With no --device each CLI asks for the card, and raises without one
    (the card is hidden where there is one, so the test holds there too)."""
    from s2m2_torch.demo import _scenes
    monkeypatch.setattr(_scenes, "SIZE", SIZE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_cli(name, argv, monkeypatch)


def test_2d_demo_paths_come_in_pairs(monkeypatch, capsys):
    assert run_cli("visualize_2d_simple", ["--left_path", "l.png"], monkeypatch) == 2
    assert "--left_path and --right_path" in capsys.readouterr().err
