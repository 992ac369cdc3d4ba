"""The benchmark's plain reference against the original reference's golden
outputs, with the bounds the port's own golden test holds (disp 2e-2 px,
occ and conf 2e-3, end-point error 1e-3 px)."""
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import model as ref

ROOT = Path(__file__).resolve().parents[2]
GOLDEN = ROOT / "tests" / "golden"
ARCH = harness.architecture(ROOT, "s2m2")


def from_jax_layout(model, flat):
    """The fixtures' JAX layouts as the model's: conv (kh, kw, I, O) ->
    (O, I, kh, kw), transposed conv -> (I, O, kh, kw), linear (I, O) -> (O, I)."""
    modules = dict(model.named_modules())
    out = {}
    for name, a in flat.items():
        t = torch.from_numpy(np.asarray(a, np.float32))
        mod, _, leaf = name.rpartition(".")
        if leaf == "weight" and t.ndim == 4:
            t = t.permute(2, 3, 0, 1) if isinstance(modules[mod], ref.ConvT) else t.permute(3, 2, 0, 1)
        elif leaf == "weight" and t.ndim == 2:
            t = t.t()
        out[name] = t.contiguous()
    return out


def load_fixture(name):
    with np.load(GOLDEN / name) as z:
        meta = [int(x) for x in z["__meta"]]
        cfg = dict(feature_channels=meta[0], num_transformer=meta[1], refine_iter=meta[2],
                   use_positivity=bool(meta[3]) if len(meta) > 3 else True,
                   output_upsample=bool(meta[4]) if len(meta) > 4 else False,
                   dim_expansion=1, num_heads=1, ot_iter=3, radius=4, pe_dim=32)
        model = ref.S2M2(cfg).eval()
        model.load_state_dict(from_jax_layout(
            model, {k: z[k] for k in z.files if not k.startswith("__")}))
        imgs = [np.transpose(z[k], (0, 2, 3, 1)) for k in ("__img0", "__img1")]
        refs = [np.transpose(z[k], (0, 2, 3, 1)) for k in ("__disp", "__occ", "__conf")]
    return model, imgs, refs


@pytest.mark.parametrize("name", ["s2m2_c32_ntr1.npz", "s2m2_c32_ntr1_neg_up.npz"])
def test_reference_matches_golden(name):
    model, imgs, refs = load_fixture(name)
    with torch.no_grad():
        outs = [o.numpy() for o in model(*(torch.from_numpy(i) for i in imgs))]
    np.testing.assert_allclose(outs[0], refs[0], atol=2e-2)
    np.testing.assert_allclose(outs[1], refs[1], atol=2e-3)
    np.testing.assert_allclose(outs[2], refs[2], atol=2e-3)
    assert np.abs(outs[0] - refs[0]).mean() < 1e-3


def test_reference_request_takes_uint8_frames():
    """The reference of a request: maps of every pair, the interior score."""
    model, imgs, refs = load_fixture("s2m2_c32_ntr1.npz")
    left = np.clip(np.rint(imgs[0]), 0, 255).astype(np.uint8)
    right = np.clip(np.rint(imgs[1]), 0, 255).astype(np.uint8)
    disp, occ, conf, score, match = ARCH.reference_request(
        model, np.concatenate([left, left]), np.concatenate([right, right]), "cpu")
    assert disp.shape == (2, *left.shape[1:3]) == occ.shape == conf.shape == match.shape
    np.testing.assert_array_equal(disp[0], disp[1])
    assert 0.0 <= match.min() and match.max() <= 1.0 and match.std() > 0
    assert score == pytest.approx(float(conf.mean()), rel=1e-6)  # 64x96: no interior
    with pytest.raises(ValueError):
        ARCH.reference_request(model, left[:, :40], right[:, :40], "cpu")


def test_clear_match_takes_the_least_of_each_neighbourhood():
    """A pixel is as clear as the least clear of its 3x3 neighbourhood at
    1/4 resolution, repeated over its 4x4 output pixels."""
    m = torch.full((1, 1, 4, 5), 0.9)
    m[0, 0, 0, 0] = 0.1
    out = ARCH.clear_match(m, (16, 20))
    assert out.shape == (1, 16, 20)
    assert torch.all(out[0, :8, :8] == 0.1) and torch.all(out[0, 8:, :] == 0.9)
    assert torch.all(out[0, :, 8:] == 0.9)
