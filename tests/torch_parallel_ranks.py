"""Shared by tests/test_torch_parallel*.py and test_torch_distributed.py: the
bodies that run on each rank of a CPU mesh, in processes of their own over
gloo, and `run`, which starts the ranks and collects what each returns.

    results = run("forward", world=4, tmp_path=tmp_path, cases=[...])

A body is a function of this module; it runs after
`initialize_distributed`, with one thread, and returns a picklable value.
Every rank process ends within `timeout` or the run fails, with each
rank's output in the error. Imports no JAX.
"""
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(feature_channels=32, num_transformer=1, refine_iter=1)


def run(name, world, tmp_path, timeout=120, stdout=False, **kwargs):
    """Run body `name`(**kwargs) on `world` ranks; returns each rank's value
    (and, with stdout=True, each rank's standard output after them)."""
    from s2m2_torch.parallel.launch import run_ranks
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    outs = run_ranks(lambda rank, init: [sys.executable, "-m", "tests.torch_parallel_ranks",
                                         name, str(rank), str(world), init, str(tmp_path),
                                         json.dumps(kwargs)],
                     world, timeout=timeout, env=env, cwd=REPO)
    values = [torch.load(os.path.join(tmp_path, f"{name}-rank{r}.pt"), weights_only=False)
              for r in range(world)]
    return (values, outs) if stdout else values


def small_pair(b=2, h=128, w=96, seed=0):
    """The JAX test's pair (tests/test_parallel.py small_setup)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32),
            rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32))


# ------------------------------------------------------------------ bodies

def _seeded(shape, seed, scale=1.0, offset=0.0):
    g = np.random.default_rng(seed)
    return torch.from_numpy((offset + scale * g.standard_normal(shape)).astype(np.float32))


def primitives(h=96):
    """Each cross-row primitive on this rank's band of an h-row map (bands
    of `band_rows(h, world)`, at the scale the case runs at) against the
    same primitive unsharded, on every rank: {case: (max |err|, |mean|)}."""
    from s2m2_torch.models import layers
    from s2m2_torch.models.layers import Conv, ConvT
    from s2m2_torch.parallel import band
    from s2m2_torch.parallel.mesh import band_rows, make_mesh
    import torch.distributed as dist
    mesh = make_mesh(1, dist.get_world_size(), device="cpu")
    rows = band_rows(h, mesh.n_band)

    def conv(cin, cout, k, stride=1):
        m = Conv(cin, cout, k, stride=stride)
        m.weight.data = _seeded(m.weight.shape, 1, 0.2)
        m.bias.data = _seeded(m.bias.shape, 2, 0.2)
        return m

    def convt(cin, cout, k, padding):
        m = ConvT(cin, cout, k, padding=padding)
        m.weight.data = _seeded(m.weight.shape, 3, 0.2)
        m.bias.data = _seeded(m.bias.shape, 4, 0.2)
        return m

    gw, gb = _seeded((16,), 5), _seeded((16,), 6)
    cases = {  # name: (op, input channels, scale of the input's rows, mean)
        "conv3x3": (conv(8, 6, 3), 8, 4, 0.0),
        "conv5x5_s2": (conv(8, 6, 5, 2), 8, 1, 0.0),
        "conv3x3_s2": (conv(8, 6, 3, 2), 8, 2, 0.0),
        "conv3x1": (conv(8, 6, (3, 1)), 8, 4, 0.0),
        "conv1x3": (conv(8, 6, (1, 3)), 8, 4, 0.0),
        "convT3x3": (convt(4, 6, 3, 1), 4, 1, 0.0),
        "upsample2x_bilinear": (layers.upsample2x_bilinear, 8, 32, 0.0),
        "unfold9": (layers.unfold9, 3, 4, 0.0),
        "output_upsample_bilinear": (layers.upsample2x_bilinear, 9, 1, 0.0),
        "group_norm_mean0": (lambda x: layers.group_norm(x, gw, gb, 8), 16, 2, 0.0),
        "group_norm_mean100": (lambda x: layers.group_norm(x, gw, gb, 8), 16, 2, 100.0),
    }
    out = {}
    with torch.no_grad():
        for i, (name, (op, c, scale, mean)) in enumerate(cases.items()):
            x = _seeded((2, c, h // scale, 20), 10 + i, 1.0, mean)
            ref = op(x)
            r0, n = sum(rows[:mesh.band]) // scale, rows[mesh.band] // scale
            with band.sharded(mesh, rows):
                got = op(x[:, :, r0:r0 + n])
            f = ref.shape[2] / x.shape[2]
            want = ref[:, :, int(r0 * f):int((r0 + n) * f)]
            assert got.shape == want.shape, (name, got.shape, want.shape)
            out[name] = (float((got - want).abs().max()), abs(mean))
    return out


def _seeded_module(mod, seed):
    """`mod` with every parameter drawn from a seeded normal, times 0.2."""
    for i, p in enumerate(mod.parameters()):
        p.data = _seeded(p.shape, seed + i, 0.2)
    return mod


def primitive_grads(h=96):
    """Each cross-row primitive's backward on this rank's band of an h-row
    map against the unsharded autograd, on every rank: the gradient of a
    seeded cotangent with respect to the band's input rows, and, for a
    primitive with parameters, their gradients summed over the bands. The
    backward runs after the band context has closed, as a training step
    runs it. {case: (max |err| of the input's gradient over max(1, its
    largest magnitude), relative L2 error of the parameters' gradient,
    |mean|, collectives of the forward and backward)}."""
    from s2m2_torch.models import layers
    from s2m2_torch.models.attention import ConvBlock2D, GlobalAttnBlock
    from s2m2_torch.models.layers import Conv, ConvT
    from s2m2_torch.models.unet import global_blocks
    from s2m2_torch.parallel import band
    from s2m2_torch.parallel.mesh import all_reduce, band_rows, make_mesh
    import torch.distributed as dist
    mesh = make_mesh(1, dist.get_world_size(), device="cpu")
    rows = band_rows(h, mesh.n_band)
    conv = lambda *a, **k: _seeded_module(Conv(*a, **k), 1)  # noqa: E731
    gw, gb = _seeded((16,), 5), _seeded((16,), 6)
    gw.requires_grad_()
    gb.requires_grad_()
    gblock = _seeded_module(GlobalAttnBlock(16, 2), 7)
    cases = {  # name: (op, its parameters, input channels, scale of the rows, mean)
        "conv3x3": (conv(8, 6, 3), 8, 4, 0.0),
        "conv5x5_s2": (conv(8, 6, 5, stride=2), 8, 1, 0.0),
        "conv3x3_s2": (conv(8, 6, 3, stride=2), 8, 2, 0.0),
        "conv3x1": (conv(8, 6, (3, 1)), 8, 4, 0.0),
        "convT3x3": (_seeded_module(ConvT(4, 6, 3, padding=1), 3), 4, 1, 0.0),
        "conv_block2d": (_seeded_module(ConvBlock2D(8), 11), 8, 4, 0.0),
        "upsample2x_bilinear": (layers.upsample2x_bilinear, 8, 32, 0.0),
        "unfold9": (layers.unfold9, 3, 4, 0.0),
        "group_norm_mean0": (lambda x: layers.group_norm(x, gw, gb, 8), 16, 2, 0.0),
        "group_norm_mean100": (lambda x: layers.group_norm(x, gw, gb, 8), 16, 2, 100.0),
        "global_blocks": (lambda x: global_blocks(x, [gblock], []), 16, 32, 0.0),
    }
    params = {"group_norm_mean0": [gw, gb], "group_norm_mean100": [gw, gb],
              "global_blocks": list(gblock.parameters())}
    out = {}
    for i, (name, (op, c, scale, mean)) in enumerate(cases.items()):
        ps = params.get(name) or (list(op.parameters()) if hasattr(op, "parameters") else [])
        x = _seeded((2, c, h // scale, 20), 10 + i, 1.0, mean).requires_grad_()
        y = op(x)
        cot = _seeded(y.shape, 40 + i)
        want = torch.autograd.grad(y, [x, *ps], cot)
        r0, n = sum(rows[:mesh.band]) // scale, rows[mesh.band] // scale
        xl = x.detach()[:, :, r0:r0 + n].clone().requires_grad_()
        band.reset_counts()
        with band.sharded(mesh, rows):
            yl = op(xl)
        f = y.shape[2] / x.shape[2]
        got = torch.autograd.grad(yl, [xl, *ps], cot[:, :, int(r0 * f):int((r0 + n) * f)])
        ref = want[0][:, :, r0:r0 + n]
        err = float((got[0] - ref).abs().max() / max(1.0, float(ref.abs().max())))
        rel = 0.0  # parameters: the bands' partial sums, relative L2
        if ps:
            total = torch.cat([all_reduce(mesh, g.clone(), mesh.band_group).reshape(-1)
                               for g in got[1:]])
            ref = torch.cat([w.reshape(-1) for w in want[1:]])
            rel = float(torch.linalg.vector_norm(total - ref) / torch.linalg.vector_norm(ref))
        out[name] = (err, rel, abs(mean), band.last_counts()["counts"])
    return out


def train_band(mesh, h=96, cfg=None, steps=0, seed=3, w=96, batch_path=None):
    """One AdamW step of `cfg` (default TRAIN) over a (data, band) `mesh` on
    this rank's shard of `train_batch(h=h, w=w, seed=seed)` (or of the batch
    saved at `batch_path`, an .npz of its arrays): the loss's
    metrics, the gradients, the parameters after the step, and the band
    collectives of the step's forward and backward beside the counts worked
    out from the config; with `steps`, `train()`'s losses over that many
    steps. Rank 0 also does both in one process on the whole batch."""
    from s2m2_torch.config import ModelConfig
    from s2m2_torch.models.init import init_params
    from s2m2_torch.models.s2m2 import S2M2
    from s2m2_torch.parallel import band
    from s2m2_torch.parallel.mesh import make_mesh
    from s2m2_torch.train import step as tstep
    from s2m2_torch.train.trainer import train
    cfg = ModelConfig(**(cfg or TRAIN))
    if batch_path is None:
        batch = train_batch(h=h, w=w, seed=seed)
    else:
        with np.load(batch_path) as z:
            batch = {k: z[k] for k in z.files}

    def one_step(m):
        model = S2M2(cfg)
        model.load_state_dict(init_params(cfg, seed=0))
        params = dict(model.named_parameters())
        opt = tstep.make_optimizer(lr=1e-3)
        opt.init(params)
        part = tstep.as_batch(tstep.shard_batch(batch, m), "cpu")
        band.reset_counts()
        metrics, grads = tstep.value_and_grad(tstep.make_loss_fn(model), params, part, m,
                                              tstep.batch_rows(batch, m))
        counts = band.last_counts()["counts"]
        opt.update(params, grads)
        return {"metrics": {k: float(v) for k, v in metrics.items()},
                "grads": {k: g.numpy() for k, g in grads.items()},
                "params": {k: p.detach().numpy().copy() for k, p in params.items()},
                "counts": counts, "shard": tuple(part["img0"].shape)}

    def losses(m):
        _, _, hist = train(cfg, iter([batch] * steps), num_steps=steps, lr=1e-3,
                           log_every=1, log=lambda _: None, device="cpu", mesh=m)
        return [x["loss"] for x in hist]

    m = make_mesh(*mesh, device="cpu")
    out = {"band": one_step(m), "expected": band.expected_counts(cfg, backward=True),
           "losses": losses(m) if steps else None}
    if m.rank == 0:
        out.update(single=one_step(None), single_losses=losses(None) if steps else None)
    return out


def forward(cases):
    """Each case's forward through `StereoEngine(mesh=...)` on the CPU in
    float32 against the unsharded engine's, with the band collectives it
    counted and the counts worked out from its config."""
    from s2m2_torch.config import ModelConfig
    from s2m2_torch.parallel import band
    from s2m2_torch.parallel.mesh import make_mesh
    from s2m2_torch.runtime.engine import StereoEngine
    out = []
    meshes = {}
    for case in cases:
        nd, nb = case["mesh"]
        if (nd, nb) not in meshes:
            meshes[(nd, nb)] = make_mesh(nd, nb, device="cpu")
        cfg = ModelConfig(**{**SMALL, **case.get("cfg", {})})
        a, b = small_pair(*case.get("shape", (2, 128, 96)))
        kw = dict(precision="fp32", device="cpu", fused_block=case.get("fused", False))
        ref_eng = StereoEngine(cfg, **kw)
        ref = ref_eng.forward_padded(a, b)
        got = StereoEngine(cfg, mesh=meshes[(nd, nb)], **kw).forward_padded(a, b)
        control = None
        if case.get("control"):
            # the unsharded forward's largest change under four 1e-6
            # relative changes of the input: a, then b, each times 1 + 1e-6
            # and 1 - 1e-6
            control = [0.0, 0.0, 0.0]
            for sign in (1, -1):
                f = np.float32(1 + sign * 1e-6)
                for pert in (ref_eng.forward_padded(a * f, b),
                             ref_eng.forward_padded(a, b * f)):
                    control = [max(c, float((p - r).abs().max()))
                               for c, p, r in zip(control, pert, ref)]
        diffs = [(g - r).abs() for g, r in zip(got, ref)]
        out.append({"err": [float(d.max()) for d in diffs],
                    "p99": [float(np.percentile(d.numpy(), 99)) for d in diffs],
                    "control": control,
                    "counts": band.last_counts()["counts"] if nb > 1 else None,
                    "expected": band.expected_counts(cfg),
                    "shapes": [tuple(g.shape) for g in got],
                    "outs": [g.numpy() for g in got] if case.get("keep") else None})
    return out


def int8(mesh=(2, 2), precision="int8"):
    """The int8 engine calibrated unsharded on the full pair (each rank
    calibrates on its own), then its band-sharded forward against the
    unsharded engine's, and the unsharded forward's change under a 1e-6
    relative input perturbation (the JAX test's intrinsic-sensitivity
    control); with E's pack and GEMM records of both forwards."""
    from s2m2_torch.config import ModelConfig
    from s2m2_torch.models import quant
    from s2m2_torch.parallel.mesh import make_mesh
    from s2m2_torch.runtime.engine import StereoEngine

    def e_records():
        log = quant.last_log()
        return {k: sum(r["kind"] == k for r in log) for k in ("pack", "gemm")}

    cfg = ModelConfig(**SMALL)
    a, b = small_pair()
    ref_eng = StereoEngine(cfg, precision=precision, device="cpu")
    ref = ref_eng.forward_padded(a, b)
    ref_e = e_records()
    pert = ref_eng.forward_padded(a * np.float32(1 + 1e-6), b)
    eng = StereoEngine(cfg, precision=precision, device="cpu", mesh=make_mesh(*mesh, device="cpu"))
    got = eng.forward_padded(a, b)
    return {"got": [g.numpy() for g in got], "ref": [r.numpy() for r in ref],
            "pert": float((pert[0] - ref[0]).abs().max()), "scales": eng.quant_scales,
            "ref_scales": ref_eng.quant_scales, "e": e_records(), "ref_e": ref_e}


TRAIN = dict(feature_channels=16, num_transformer=1, refine_iter=2)


def train_batch(b=2, h=64, w=96, seed=3):
    """A batch whose pairs have different valid masks (so different counts
    of supervised pixels at full and quarter resolution)."""
    rng = np.random.default_rng(seed)
    img0 = rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    valid = np.ones((b, h, w, 1), np.float32)
    valid[0, :20, :30] = 0
    valid[1] = (rng.uniform(size=(h, w, 1)) > 0.3).astype(np.float32)
    return {"img0": img0, "img1": np.roll(img0, -4, axis=2),
            "gt_disp": rng.uniform(0, 12, (b, h, w, 1)).astype(np.float32),
            "valid": valid}


def train_dp(steps=2):
    """One data-parallel AdamW step on this rank's pair of `train_batch`
    (loss, gradients, parameters after it), then `train()` on the mesh for
    `steps` steps; rank 0 also does both in one process on the whole batch."""
    import torch.distributed as dist
    from s2m2_torch.config import ModelConfig
    from s2m2_torch.models.init import init_params
    from s2m2_torch.models.s2m2 import S2M2
    from s2m2_torch.parallel.mesh import make_mesh
    from s2m2_torch.train import step as tstep
    from s2m2_torch.train.trainer import train
    cfg = ModelConfig(**TRAIN)
    batch = train_batch()

    def one_step(mesh):
        model = S2M2(cfg)
        model.load_state_dict(init_params(cfg, seed=0))
        params = dict(model.named_parameters())
        opt = tstep.make_optimizer(lr=1e-3)
        opt.init(params)
        part = tstep.as_batch(tstep.shard_batch(batch, mesh), "cpu")
        metrics, grads = tstep.value_and_grad(tstep.make_loss_fn(model), params, part, mesh)
        opt.update(params, grads)
        return {"metrics": {k: float(v) for k, v in metrics.items()},
                "grads": {k: g.numpy() for k, g in grads.items()},
                "params": {k: p.detach().numpy().copy() for k, p in params.items()}}

    def losses(mesh):
        _, _, hist = train(cfg, iter([batch] * steps), num_steps=steps, lr=1e-3,
                           log_every=1, log=lambda _: None, device="cpu", mesh=mesh)
        return [h["loss"] for h in hist]

    mesh = make_mesh(dist.get_world_size(), 1, device="cpu")
    out = {"dp": one_step(mesh), "dp_losses": losses(mesh)}
    if mesh.rank == 0:
        out.update(single=one_step(None), single_losses=losses(None))
    return out


def loopback():
    """The counterpart of tests/test_distributed.py's loopback: the global
    mesh of this host's ranks and an all_gather of rank + 1."""
    import torch.distributed as dist
    from s2m2_torch.parallel.distributed import global_mesh
    mesh = global_mesh(device="cpu")
    parts = [torch.zeros(1) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, torch.tensor([float(dist.get_rank() + 1)]),
                    group=mesh.world_group)
    print("ALLGATHER", sorted(float(p) for p in parts), flush=True)
    return {"shape": mesh.shape, "coords": (mesh.data, mesh.band),
            "transport": mesh.transport}


def halo_timeout(timeout=3.0):
    """Rank 0 asks for a halo that rank 1 never sends: the exchange must
    raise once the group's timeout has passed, not hang. Returns (what rank
    0 raised, seconds it waited); rank 1 waits, then returns."""
    import time
    import torch.distributed as dist
    from s2m2_torch.parallel import band
    from s2m2_torch.parallel.mesh import make_mesh
    mesh = make_mesh(1, 2, device="cpu", timeout=timeout)
    if dist.get_rank() == 1:
        time.sleep(3 * timeout)
        return None
    t0 = time.monotonic()
    try:
        with band.sharded(mesh, [32, 32]):
            band.halo(torch.zeros(1, 1, 4, 4), 1, 1)
    except RuntimeError as exc:
        return (type(exc).__name__, str(exc)[:300], time.monotonic() - t0)
    return ("no error", "", time.monotonic() - t0)


def engine_checks():
    """`StereoEngine(mesh=...).run` on HWC images against the unsharded
    engine, and the two mistakes the mesh refuses: a batch that does not
    split over the data ranks, a band split with fewer 32-row blocks than
    bands. Returns the errors and the messages."""
    import torch.distributed as dist
    from s2m2_torch.config import ModelConfig
    from s2m2_torch.parallel.mesh import make_mesh
    from s2m2_torch.runtime.engine import StereoEngine
    world = dist.get_world_size()
    cfg = ModelConfig(**SMALL)
    a, b = small_pair(1, 100, 90)
    ref = StereoEngine(cfg, precision="fp32", device="cpu").run(a[0], b[0])
    band_eng = StereoEngine(cfg, precision="fp32", device="cpu",
                            mesh=make_mesh(1, world, device="cpu"))
    got = band_eng.run(a[0], b[0])
    out = {"err": [float(np.abs(g - r).max()) for g, r in zip(got[:3], ref[:3])],
           "shape": got[0].shape, "ms": got[4]}
    data_eng = StereoEngine(cfg, precision="fp32", device="cpu",
                            mesh=make_mesh(world, 1, device="cpu"))
    try:
        data_eng.forward_padded(*small_pair(1, 64, 64))
    except ValueError as exc:
        out["odd_batch"] = str(exc)
    try:
        band_eng.forward_padded(*small_pair(1, 32, 64))
    except ValueError as exc:
        out["few_blocks"] = str(exc)
    return out


if __name__ == "__main__":
    name, rank, world, init, out_dir, kwargs = sys.argv[1:7]
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from s2m2_torch.parallel.distributed import initialize_distributed
    initialize_distributed(init, int(world), int(rank))
    result = globals()[name](**json.loads(kwargs))
    torch.save(result, os.path.join(out_dir, f"{name}-rank{rank}.pt"))
    if name != "halo_timeout":  # a group whose exchange timed out is not torn down
        torch.distributed.destroy_process_group()
