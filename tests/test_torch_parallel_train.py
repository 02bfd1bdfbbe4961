"""The port's meshed training (one process per mesh position, gloo on the
CPU) against its one-rank step and against the JAX package's meshed step
on 8 fake devices, at the ``tiny_cfg`` scale in float32.

One set of 4 processes, started once for the module at mesh (2, 2), runs
every meshed case for FSDP off and on: the shards each rank holds, one CP
and one CIR step with the same dropout masks injected into every package
(ragged negative masks in CIR, so that the global valid-negative count
shows), a dropout-on CP step with the port's own generators, a step whose
clip is active, a resume from a JAX checkpoint of sharded parameters, and
a CP -> CIR -> FITB chain of the real trainers whose checkpoints the JAX
package reads, and the dropout-on CP step again with remat under each
policy. Each case is compared here with the port's one-rank run in this
process (1e-5) and, where given, with JAX (1e-4); the remat steps with the
same mesh's plain step, bit for bit, and their collective bytes with the
plain step's plus the recomputed forward collectives.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P
from outfitx_tpu.core import config as jcfg
from outfitx_tpu.core.mesh import MeshSpec as JaxMeshSpec
from outfitx_tpu.core.mesh import make_mesh as jax_make_mesh
from outfitx_tpu.core.mesh import shard_params as jax_shard_params
from outfitx_tpu.models import OutfitXModel as JaxModel
from outfitx_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from outfitx_tpu.train.optim import make_optimizer
from outfitx_tpu.train.state import TrainState as JaxState
from outfitx_tpu.train.steps import make_cir_train_step, make_cp_train_step
from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.core import rng as trng
from outfitx_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS
from outfitx_tpu_torch.data.synthetic import make_synthetic
from outfitx_tpu_torch.models import OutfitXModel, load_jax_checkpoint, state_dict_from_jax
from outfitx_tpu_torch.models.outfit_transformer import (
    join_state_dicts,
    param_partition_specs,
    shard_state_dict,
)
from outfitx_tpu_torch.train.cir_trainer import CIRTrainer
from outfitx_tpu_torch.train.cp_trainer import CPTrainer
from outfitx_tpu_torch.train.fitb_trainer import FITBTrainer
from outfitx_tpu_torch.train.optim import AdamW
from outfitx_tpu_torch.train.state import TrainState
from outfitx_tpu_torch.train.steps import cir_train_step, cp_train_step

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
KEEP = 179 / 256
A, B, K, N_ROWS = 2, 8, 5, 60
MESHES = {"tp": (2, 2, False), "fsdp": (2, 2, True)}
CHAIN = dict(cp_epochs=2, cir_epochs=3, switch=2)


def port_config(cfg):
    import dataclasses

    def copy(cls, src):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dataclasses.asdict(src).items() if k in names})

    return tcfg.OutfitXConfig(
        item_encoder=copy(tcfg.ItemEncoderConfig, cfg.item_encoder),
        transformer=copy(tcfg.TransformerConfig, cfg.transformer),
        max_outfit_len=cfg.max_outfit_len,
        param_dtype=cfg.param_dtype,
        compute_dtype=cfg.compute_dtype,
    )


class Masks:
    """One fixed keep mask per dropout site at the global batch's shapes,
    told apart by shape and, for the two (B, S, d) sites of a layer, by
    the order of the calls (attention output, then FFN output). The same
    class runs in the workers (the source is copied there)."""

    def __init__(self, arrays):
        self.masks = arrays
        self.calls = 0

    def __call__(self, shape):
        shape = tuple(shape)
        for site in ("hidden", "head"):
            if self.masks[site].shape == shape:
                return self.masks[site]
        site = ("attn", "out")[self.calls % 2]
        self.calls += 1
        return self.masks[site]


def _mask_arrays(b, s, d, ffn, seed=3):
    rng = np.random.default_rng(seed)
    shapes = {"attn": (b, s, d), "out": (b, s, d), "hidden": (b, s, ffn), "head": (b, d)}
    return {k: rng.random(v) < KEEP for k, v in shapes.items()}


_WORKER = r'''
import dataclasses, json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
args = json.load(open(sys.argv[1]))
sys.path.insert(0, args["repo"])

from outfitx_tpu_torch.core import config as tcfg
from outfitx_tpu_torch.core import rng as trng
from outfitx_tpu_torch.data.synthetic import make_synthetic
from outfitx_tpu_torch.models import OutfitXModel
from outfitx_tpu_torch.parallel import setup_parallel
from outfitx_tpu_torch.train.cir_trainer import CIRTrainer
from outfitx_tpu_torch.train.cp_trainer import CPTrainer
from outfitx_tpu_torch.train.fitb_trainer import FITBTrainer
from outfitx_tpu_torch.train.optim import AdamW
from outfitx_tpu_torch.train.state import TrainState
from outfitx_tpu_torch.train.steps import cir_train_step, cp_train_step

MASKS_SRC
KEEP = 179 / 256

cfg = tcfg.OutfitXConfig(**{
    "item_encoder": tcfg.ItemEncoderConfig(**args["cfg"]["item_encoder"]),
    "transformer": tcfg.TransformerConfig(**args["cfg"]["transformer"]),
    **{k: v for k, v in args["cfg"].items() if k not in ("item_encoder", "transformer")},
})
inputs = dict(np.load(args["inputs"]))
sd0 = {k[3:]: torch.from_numpy(v) for k, v in inputs.items() if k.startswith("sd.")}
masks = {k[5:]: v for k, v in inputs.items() if k.startswith("mask.")}
catalog = torch.from_numpy(inputs["catalog"])
results = {}
mesh = tcfg.MeshConfig(*args["mesh"])
par = setup_parallel(mesh, "cpu")
rank = par.rank


def inject():
    m = Masks(masks)
    trng.keep_mask = lambda gen, rate, shape, device: (torch.from_numpy(m(shape)), KEEP)


def fresh(clip=1.0, model_cfg=cfg):
    model = OutfitXModel(model_cfg, device="cpu", trainable=True)
    model.load_state_dict(sd0)
    model.shard_(par)
    opt = AdamW(model.parameters(), tcfg.OptimizerConfig(learning_rate=1e-3, clip_norm=clip), 10, par=par)
    return model, TrainState.create(model, opt, seed=0, par=par)


def record(tag, model, out):
    results[tag + "/loss"] = float(out["loss"])
    params = dict(model.named_parameters())
    for n, p in params.items():
        results[tag + "/param/" + n] = par.full(p, p.data).numpy().copy()
        if p.grad is not None:
            results[tag + "/grad/" + n] = par.full(p, p.grad).numpy().copy()


batch = lambda prefix: {k[len(prefix):]: torch.from_numpy(v) for k, v in inputs.items() if k.startswith(prefix)}
real_keep_mask = trng.keep_mask

model, state = fresh()
for n, t in model.state_dict().items():
    results[f"shard{rank}/{n}"] = t.numpy().copy()
inject()
record("cp", model, cp_train_step(state, catalog, batch("cp.")))
model, state = fresh()
inject()
record("cir", model, cir_train_step(state, catalog, batch("cir.")))
trng.keep_mask = real_keep_mask
for tag, model_cfg in [("dropout", cfg)] + [
    ("remat_" + p, dataclasses.replace(cfg, remat=True, remat_policy=p))
    for p in ("full", "masks", "dots")
]:
    model, state = fresh(model_cfg=model_cfg)
    moved = par.bytes_moved
    out = cp_train_step(state, catalog, batch("cp."))
    results[tag + "/bytes"] = par.bytes_moved - moved
    record(tag, model, out)
model, state = fresh(clip=1e-3)
out = cp_train_step(state, catalog, batch("cp."))
grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in state.optimizer.params]
results["clip/sq_norm"] = float(par.grad_sq_norm(state.optimizer.params, grads))
record("clip", model, out)

# the real trainers: a CP -> CIR -> FITB chain, then a resume from JAX
data = make_synthetic(n_items=400, d_embed=cfg.d_embed, n_outfits=256, max_len=cfg.max_outfit_len, seed=11)
chain_cfg = cfg.__class__(**{**cfg.__dict__, "transformer": tcfg.TransformerConfig(**{**args["cfg"]["transformer"], "dropout": 0.0})})
root = args["chain_dir"]
ckpt, logs = root + "/ckpt", root + "/logs"
c = args["chain"]
with CPTrainer(tcfg.CPTrainConfig(
    n_epochs=c["cp_epochs"], batch_size=32, accumulation_steps=2, seed=11, mesh=mesh,
    optimizer=tcfg.OptimizerConfig(learning_rate=2e-3), checkpoint_dir=ckpt, log_dir=logs,
), chain_cfg, catalog=data.catalog, train_split=data.cp_train, valid_split=data.cp_valid, device="cpu") as t:
    t.load_params(t.model, sd0)
    t.run()
    cp_name = t.model_name
    results["chain/cp_bytes"] = t.par.bytes_moved
with CIRTrainer(tcfg.CIRTrainConfig(
    n_epochs=c["cir_epochs"], batch_size=32, accumulation_steps=1, seed=11, mesh=mesh,
    switch_to_hard_epoch=c["switch"], recall_every=1, candidate_pool_size=64,
    checkpoint_dir=ckpt, log_dir=logs, warm_start_from=ckpt + "/" + cp_name + "/best_auc",
), chain_cfg, catalog=data.catalog, train_split=data.cir_train, valid_split=data.cir_valid,
    pool_threshold=1, device="cpu") as t:
    t.run()
    cir_name = t.model_name
with FITBTrainer(tcfg.FITBTrainConfig(
    checkpoint_dir=ckpt, log_dir=logs, mesh=mesh,
    checkpoint_from=ckpt + "/" + cir_name + "/best_recall@1",
), chain_cfg, "test", catalog=data.catalog, test_split=data.fitb_test, device="cpu") as t:
    results["chain/fitb"] = t.run()["accuracy"]
with CPTrainer(tcfg.CPTrainConfig(
    n_epochs=1, batch_size=32, mesh=mesh, checkpoint_dir=root + "/resume", log_dir=logs,
), chain_cfg, catalog=data.catalog, train_split=data.cp_train, valid_split=data.cp_valid, device="cpu") as t:
    t.resume(args["jax_ckpt"])
    results["resume/epoch"] = t.epoch
    results["resume/step"] = t.state.step
    results["resume/count"] = t.state.optimizer.count
    names = {id(p): n for n, p in t.model.named_parameters()}
    for key in ("mu", "nu"):
        for p, m in zip(t.state.optimizer.params, getattr(t.state.optimizer, key)):
            results[f"resume{rank}/{key}/{names[id(p)]}"] = m.numpy().copy()
    for n, p in t.model.named_parameters():
        results[f"resume{rank}/{n}"] = p.data.numpy().copy()
    for n, v in t.full_params(t.model).items():
        results["resume/full/" + n] = v.numpy().copy()
    t.run_mode = "test"  # no final save

np.savez(args["out"] + f".rank{rank}.npz", **results)
torch.distributed.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(tmp, name, mesh, inputs, cfg_json, jax_ckpt):
    """Run the worker on 4 gloo processes at ``mesh``; returns each rank's
    results."""
    import inspect

    src = _WORKER.replace("MASKS_SRC", inspect.getsource(Masks))
    script = tmp / "worker.py"
    script.write_text(src)
    args = {
        "repo": str(REPO), "mesh": list(mesh), "inputs": str(inputs), "cfg": cfg_json,
        "out": str(tmp / name), "chain_dir": str(tmp / name / "chain"), "chain": CHAIN,
        "jax_ckpt": str(jax_ckpt),
    }
    (tmp / f"{name}.json").write_text(json.dumps(args))
    port, world = _free_port(), mesh[0] * mesh[1]
    procs = []
    for r in range(world):
        env = dict(
            os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
            LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port),
            OMP_NUM_THREADS="1",
        )
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(tmp / f"{name}.json")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    return procs


def _collect(procs, tmp, name):
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(tmp / f"{name}.rank{r}.npz")) for r in range(len(procs))]


# ------------------------------------------------------------- fixture --


@pytest.fixture(scope="module")
def setup(tiny_cfg, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    jmodel = JaxModel(tiny_cfg)
    params = jmodel.init(jax.random.PRNGKey(2))
    host = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    sd0 = {k: v.numpy() for k, v in state_dict_from_jax(host).items()}
    d, ffn, L = tiny_cfg.d_embed, tiny_cfg.transformer.d_ffn, tiny_cfg.max_outfit_len
    catalog = rng.standard_normal((N_ROWS, d)).astype(np.float32)
    lengths = rng.integers(1, L + 1, (A, B))
    mask = np.arange(L)[None, None, :] >= lengths[..., None]
    item_idx = rng.integers(0, N_ROWS, (A, B, L)).astype(np.int32)
    cp = {"item_idx": item_idx, "mask": mask,
          "label": (rng.random((A, B)) > 0.5).astype(np.float32)}
    # ragged negatives: the data ranks' valid counts differ (rows 0-3
    # keep few, rows 4-7 most)
    neg_mask = np.zeros((A, B, K), bool)
    neg_mask[:, : B // 2, 1:] = True
    neg_mask[:, B // 2 :, -1] = rng.random((A, B // 2)) < 0.5
    cir = {"item_idx": item_idx, "mask": mask,
           "pos_idx": rng.integers(0, N_ROWS, (A, B)).astype(np.int32),
           "neg_idx": rng.integers(0, N_ROWS, (A, B, K)).astype(np.int32),
           "neg_mask": neg_mask}
    masks = _mask_arrays(B, L + 1, d, ffn)
    inputs = tmp / "inputs.npz"
    np.savez(
        inputs, catalog=catalog,
        **{f"sd.{k}": v for k, v in sd0.items()},
        **{f"mask.{k}": v for k, v in masks.items()},
        **{f"cp.{k}": v for k, v in cp.items()},
        **{f"cir.{k}": v for k, v in cir.items()},
    )
    # a JAX checkpoint of parameters sharded over mesh (2, 2) with FSDP
    jmesh = jax_make_mesh(JaxMeshSpec(data=2, model=2))
    sharded = jax_shard_params(jmesh, params, jmodel.param_partition_specs(fsdp=True))
    jckpt = JaxCheckpoints(tmp / "jaxckpt", "meshed")
    jax_ckpt = jckpt.save("latest", params=sharded, opt_state=_optax_state(params), step=3, epoch=4)
    import dataclasses

    cfg_json = dataclasses.asdict(port_config(tiny_cfg))
    procs = {
        name: _spawn(tmp, name, mesh, inputs, cfg_json, jax_ckpt)
        for name, mesh in MESHES.items()
    }
    # meanwhile, in this process: the one-rank port and JAX's meshed steps
    single = _single_runs(tiny_cfg, sd0, catalog, cp, cir, masks, tmp)
    jaxed = {name: _jax_runs(tiny_cfg, params, catalog, cp, cir, masks, mesh)
             for name, mesh in MESHES.items()}
    meshed = {name: _collect(p, tmp, name) for name, p in procs.items()}
    return {
        "tmp": tmp, "sd0": sd0, "params": params, "single": single, "jax": jaxed,
        "meshed": meshed, "cfg": tiny_cfg, "jmesh": jmesh, "jax_ckpt": jax_ckpt,
    }


def _optax_state(params, count=3):
    """The JAX optimizer's state over ``params`` with ``count`` steps taken
    and random moments (nu positive)."""
    clip, (adam, decay, sched) = make_optimizer(jcfg.OptimizerConfig(), 10).init(params)
    rng = np.random.default_rng(4)
    mu, nu = (
        jax.tree.map(lambda x: f(rng.standard_normal(x.shape)).astype(np.float32), params)
        for f in (lambda a: a, np.abs)
    )
    n = jnp.asarray(count, jnp.int32)
    return (clip, (adam._replace(count=n, mu=mu, nu=nu), decay, sched._replace(count=n)))


def _patch_port_masks(masks):
    m = Masks(masks)
    trng.keep_mask = lambda gen, rate, shape, device: (torch.from_numpy(m(shape)), KEEP)


def _record(out, tag, model, loss):
    out[tag + "/loss"] = float(loss)
    for n, p in model.named_parameters():
        out[tag + "/param/" + n] = p.detach().numpy().copy()
        if p.grad is not None:
            out[tag + "/grad/" + n] = p.grad.numpy().copy()


def _single_runs(cfg, sd0, catalog, cp, cir, masks, tmp):
    out = {}
    pcfg = port_config(cfg)
    cat = torch.from_numpy(catalog)

    def fresh(clip=1.0):
        model = OutfitXModel(pcfg, device="cpu", trainable=True)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd0.items()})
        opt = AdamW(model.parameters(), tcfg.OptimizerConfig(learning_rate=1e-3, clip_norm=clip), 10)
        return model, TrainState.create(model, opt, seed=0)

    real = trng.keep_mask
    try:
        for tag, step, batch in (("cp", cp_train_step, cp), ("cir", cir_train_step, cir)):
            model, state = fresh()
            _patch_port_masks(masks)
            res = step(state, cat, {k: torch.from_numpy(v) for k, v in batch.items()})
            _record(out, tag, model, res["loss"])
    finally:
        trng.keep_mask = real
    model, state = fresh()
    res = cp_train_step(state, cat, {k: torch.from_numpy(v) for k, v in cp.items()})
    _record(out, "dropout", model, res["loss"])
    model, state = fresh(clip=1e-3)
    res = cp_train_step(state, cat, {k: torch.from_numpy(v) for k, v in cp.items()})
    out["clip/sq_norm"] = float(sum((p.grad.double() ** 2).sum() for p in model.parameters() if p.grad is not None))
    _record(out, "clip", model, res["loss"])
    out["chain"] = _single_chain(pcfg, sd0, tmp / "single_chain")
    return out


def _chain_cfg(pcfg):
    import dataclasses

    return dataclasses.replace(
        pcfg, transformer=dataclasses.replace(pcfg.transformer, dropout=0.0)
    )


def _single_chain(pcfg, sd0, root):
    data = make_synthetic(n_items=400, d_embed=pcfg.d_embed, n_outfits=256,
                          max_len=pcfg.max_outfit_len, seed=11)
    cfg = _chain_cfg(pcfg)
    ckpt, logs = str(root / "ckpt"), str(root / "logs")
    with CPTrainer(tcfg.CPTrainConfig(
        n_epochs=CHAIN["cp_epochs"], batch_size=32, accumulation_steps=2, seed=11,
        optimizer=tcfg.OptimizerConfig(learning_rate=2e-3), checkpoint_dir=ckpt, log_dir=logs,
    ), cfg, catalog=data.catalog, train_split=data.cp_train, valid_split=data.cp_valid,
            device="cpu") as t:
        t.model.load_state_dict({k: torch.from_numpy(v) for k, v in sd0.items()})
        t.run()
        cp_name = t.model_name
    with CIRTrainer(tcfg.CIRTrainConfig(
        n_epochs=CHAIN["cir_epochs"], batch_size=32, accumulation_steps=1, seed=11,
        switch_to_hard_epoch=CHAIN["switch"], recall_every=1, candidate_pool_size=64,
        checkpoint_dir=ckpt, log_dir=logs, warm_start_from=f"{ckpt}/{cp_name}/best_auc",
    ), cfg, catalog=data.catalog, train_split=data.cir_train, valid_split=data.cir_valid,
            pool_threshold=1, device="cpu") as t:
        t.run()
        cir_name = t.model_name
    with FITBTrainer(tcfg.FITBTrainConfig(
        checkpoint_dir=ckpt, log_dir=logs, checkpoint_from=f"{ckpt}/{cir_name}/best_recall@1",
    ), cfg, "test", catalog=data.catalog, test_split=data.fitb_test, device="cpu") as t:
        fitb = t.run()["accuracy"]
    return {"root": root, "cp": cp_name, "cir": cir_name, "fitb": fitb}


def _capture_grads():
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda g, state, params=None: (g, {"g": g}),
    )


def _jax_runs(cfg, params, catalog, cp, cir, masks, mesh):
    """JAX's CP and CIR steps on a (data, model) mesh of the fake devices,
    the parameters placed by its partition specs, the batch split over
    'data', the same masks injected."""
    import outfitx_tpu.core.rng as jrng

    d, m, fsdp = mesh
    jmesh = jax_make_mesh(JaxMeshSpec(data=d, model=m))
    model = JaxModel(cfg)
    out = {}
    real = jrng.keep_mask
    try:
        for tag, make, batch in (("cp", make_cp_train_step, cp), ("cir", make_cir_train_step, cir)):
            mk = Masks(masks)
            jrng.keep_mask = lambda key, rate, shape: (jnp.asarray(mk(shape)), KEEP)
            tx = optax.chain(_capture_grads(), make_optimizer(
                jcfg.OptimizerConfig(learning_rate=1e-3), 10))
            with jax.set_mesh(jmesh):
                p = jax_shard_params(jmesh, params, model.param_partition_specs(fsdp=fsdp))
                data = jax.device_put(
                    jax.tree.map(jnp.asarray, batch), NamedSharding(jmesh, P(None, "data"))
                )
                new, res = make(model, tx, donate=False)(
                    JaxState.create(p, tx, jax.random.PRNGKey(3)), jnp.asarray(catalog), data
                )
            host = lambda t: jax.tree.map(lambda x: np.asarray(x, np.float32), t)
            out[tag + "/loss"] = float(res["loss"])
            out[tag + "/params"] = {k: v.numpy() for k, v in state_dict_from_jax(host(new.params)).items()}
            out[tag + "/grads"] = {k: v.numpy() for k, v in state_dict_from_jax(host(new.opt_state[0]["g"])).items()}
    finally:
        jrng.keep_mask = real
    return out


# -------------------------------------------------------------- helpers --


def _comparable(name, t, d):
    """Leave out the key third of in_proj_bias: its gradient is rounding
    noise (softmax ignores a shift shared by a row's scores), which Adam's
    first step turns into O(lr) updates."""
    return np.concatenate([t[:d], t[2 * d:]]) if name.endswith("in_proj_bias") else t


def _assert_close(got, want, prefix, *, atol, rtol, d):
    names = sorted(k[len(prefix):] for k in want if k.startswith(prefix))
    assert names
    for n in names:
        np.testing.assert_allclose(
            _comparable(n, got[prefix + n], d), _comparable(n, want[prefix + n], d),
            atol=atol, rtol=rtol, err_msg=prefix + n,
        )


# --------------------------------------------------------------- shards --


@pytest.mark.parametrize("name", sorted(MESHES))
def test_rank_shards_equal_jax_addressable_shards(setup, name):
    """Rank r's blocks (its live parameters after ``shard_``) equal, bit for
    bit, the addressable shard of JAX's array on device (d, m) of the same
    mesh, through the port's own weight mapping."""
    d, m, fsdp = MESHES[name]
    jmodel = JaxModel(setup["cfg"])
    jmesh = jax_make_mesh(JaxMeshSpec(data=d, model=m))
    sharded = jax_shard_params(jmesh, setup["params"], jmodel.param_partition_specs(fsdp=fsdp))
    devices = np.asarray(jmesh.devices)
    results = setup["meshed"][name]
    for rank in range(d * m):
        pos = (rank // m, rank % m)
        dev = devices[pos]
        tree = jax.tree.map(
            lambda a: next(np.asarray(s.data, np.float32) for s in a.addressable_shards
                           if s.device == dev),
            sharded,
        )
        want = state_dict_from_jax(tree)
        got = {k.split("/", 1)[1]: v for k, v in results[rank].items() if k.startswith(f"shard{rank}/")}
        assert sorted(got) == sorted(want)
        for n in want:
            np.testing.assert_array_equal(got[n], want[n].numpy(), err_msg=f"rank {rank} {n}")
        # the host helper cuts the same blocks
        mine = shard_state_dict(setup["sd0"], port_config(setup["cfg"]),
                                {DATA_AXIS: d, MODEL_AXIS: m}, pos, fsdp=fsdp)
        for n in want:
            np.testing.assert_array_equal(mine[n], want[n].numpy())


@pytest.mark.parametrize("fsdp", [False, True])
def test_join_inverts_shard(setup, fsdp):
    cfg = port_config(setup["cfg"])
    shape = {DATA_AXIS: 2, MODEL_AXIS: 2}
    parts = {(d, m): shard_state_dict(setup["sd0"], cfg, shape, (d, m), fsdp=fsdp)
             for d in range(2) for m in range(2)}
    whole = join_state_dicts(parts, cfg, shape, fsdp=fsdp)
    for n, v in setup["sd0"].items():
        np.testing.assert_array_equal(whole[n], v)


def test_partition_specs_mirror_jax(setup):
    """Every split of the JAX specs has its counterpart: the axes named by
    the port's specs of each parameter are the JAX leaf's, for FSDP off and
    on."""
    cfg = port_config(setup["cfg"])
    jspecs = JaxModel(setup["cfg"]).param_partition_specs(fsdp=True)
    specs = param_partition_specs(cfg, fsdp=True)
    layer0 = {k.split("layers.0.", 1)[1]: v for k, v in specs.items() if "layers.0." in k}
    a = jspecs["layers"]
    pairs = {
        "self_attn.in_proj_weight": a["attn"]["wqkv"], "self_attn.out_proj.weight": a["attn"]["wo"],
        "linear1.weight": a["ffn"]["w1"], "linear2.weight": a["ffn"]["w2"],
        "linear1.bias": a["ffn"]["b1"], "linear2.bias": a["ffn"]["b2"],
    }
    for name, jspec in pairs.items():
        assert sorted(x for x in layer0[name] if x) == sorted(x for x in jspec if x), name
    assert all(not any(v) for k, v in specs.items() if "layers" not in k)


# ---------------------------------------------------------------- steps --


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("task", ["cp", "cir"])
def test_meshed_step_matches_one_rank_and_jax(setup, name, task):
    """One step (A=2, masks injected) at mesh (2, 2): the loss, the whole
    gradient and the updated parameters equal the port's one-rank step to
    1e-5 and JAX's meshed step to 1e-4."""
    got = setup["meshed"][name][0]
    single = setup["single"]
    d = setup["cfg"].d_embed
    np.testing.assert_allclose(got[f"{task}/loss"], single[f"{task}/loss"], atol=1e-5, rtol=1e-5)
    _assert_close(got, single, f"{task}/grad/", atol=1e-5, rtol=1e-4, d=d)
    _assert_close(got, single, f"{task}/param/", atol=1e-5, rtol=1e-5, d=d)
    jx = setup["jax"][name]
    np.testing.assert_allclose(got[f"{task}/loss"], jx[f"{task}/loss"], atol=1e-4, rtol=1e-4)
    want_g = {f"{task}/grad/{k}": v for k, v in jx[f"{task}/grads"].items()
              if f"{task}/grad/{k}" in got}
    _assert_close(got, want_g, f"{task}/grad/", atol=1e-4, rtol=1e-4, d=d)
    want_p = {f"{task}/param/{k}": v for k, v in jx[f"{task}/params"].items()}
    _assert_close(got, want_p, f"{task}/param/", atol=1e-4, rtol=1e-4, d=d)


def test_ragged_negatives_need_the_global_count(setup):
    """The CIR batch's data halves hold different valid-negative counts, so
    the mean of the ranks' own losses is not the global loss, and the
    meshed step reports the global one."""
    from outfitx_tpu_torch.losses import set_wise_ranking_loss

    inputs = dict(np.load(setup["tmp"] / "inputs.npz"))
    nm = inputs["cir.neg_mask"][0]
    counts = [(~nm[: B // 2]).sum(), (~nm[B // 2 :]).sum()]
    assert counts[0] != counts[1]
    rng = np.random.default_rng(5)
    pos, pred = (torch.from_numpy(rng.standard_normal((B, 8)).astype(np.float32)) for _ in range(2))
    negs = torch.from_numpy(rng.standard_normal((B, K, 8)).astype(np.float32))
    mask = torch.from_numpy(nm)
    whole = set_wise_ranking_loss(pos, pred, negs, mask)
    halves = [slice(0, B // 2), slice(B // 2, B)]
    local_mean = np.mean([float(set_wise_ranking_loss(pos[h], pred[h], negs[h], mask[h])) for h in halves])
    shares = sum(
        float(set_wise_ranking_loss(pos[h], pred[h], negs[h], mask[h],
                                    valid_count=(~mask).sum().float(), batch_size=B))
        for h in halves
    )
    assert abs(local_mean - float(whole)) > 1e-3
    np.testing.assert_allclose(shares, float(whole), rtol=1e-6)
    for name in MESHES:
        np.testing.assert_allclose(
            setup["meshed"][name][0]["cir/loss"], setup["single"]["cir/loss"], rtol=1e-6
        )


@pytest.mark.parametrize("name", sorted(MESHES))
def test_dropout_on_meshed_step_equals_one_rank(setup, name):
    """The port's own generators: each rank draws the global batch's masks
    and keeps its rows (and FFN columns), so the meshed step is the
    one-rank step."""
    got, single = setup["meshed"][name][0], setup["single"]
    np.testing.assert_allclose(got["dropout/loss"], single["dropout/loss"], atol=1e-6, rtol=1e-5)
    assert abs(got["dropout/loss"] - got["cp/loss"]) > 1e-4  # other masks than injected
    _assert_close(got, single, "dropout/param/", atol=1e-5, rtol=1e-5, d=setup["cfg"].d_embed)


def _recomputed_bytes(cfg, mesh, a):
    """The collective bytes of one forward of the encoder layers over
    ``a`` microbatches of B rows, as one rank counts them: FSDP's
    all-gather of its block of the four layer matrices (float32) and the
    model axis's two g all-reduces of its rows' (B/data, S, d) states (with
    dropout on: without, the recompute stops before the second)."""
    data, model, fsdp = mesh
    d, ffn, s = cfg.d_embed, cfg.transformer.d_ffn, cfg.max_outfit_len + 1
    per_layer = 0
    if fsdp and data > 1:
        per_layer += (4 * d * d + 2 * ffn * d) // (data * model) * 4
    if model > 1:
        per_layer += (2 if cfg.transformer.dropout else 1) * (B // data) * s * d * 4
    return a * cfg.transformer.n_layers * per_layer


@pytest.mark.parametrize("policy", ["full", "masks", "dots"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_meshed_remat_step_equals_the_plain_step(setup, name, policy):
    """The dropout-on CP step with remat on each rank of the mesh: the
    loss, the whole gradients and the updated parameters equal the same
    mesh's plain step bit for bit (the recompute redoes the same
    arithmetic and collectives on the same masks), and the step moves
    exactly the recomputed forward collectives more."""
    tag = "remat_" + policy
    extra = _recomputed_bytes(setup["cfg"], MESHES[name], A)
    assert extra > 0
    for res in setup["meshed"][name]:
        assert res[tag + "/loss"] == res["dropout/loss"]
        for key in res:
            if key.startswith(("dropout/grad/", "dropout/param/")):
                np.testing.assert_array_equal(res[tag + key[len("dropout"):]], res[key], err_msg=key)
        assert res[tag + "/bytes"] == res["dropout/bytes"] + extra


@pytest.mark.parametrize("name", sorted(MESHES))
def test_clip_uses_the_global_norm(setup, name):
    """clip_norm 1e-3 clips the step: the update depends on the global
    norm, summed over the shards with each replicated leaf once."""
    got, single = setup["meshed"][name][0], setup["single"]
    assert single["clip/sq_norm"] > 1e-6
    np.testing.assert_allclose(got["clip/sq_norm"], single["clip/sq_norm"], rtol=1e-5)
    _assert_close(got, single, "clip/param/", atol=1e-5, rtol=1e-5, d=setup["cfg"].d_embed)


def test_ranks_agree_on_whole_params(setup):
    for name in MESHES:
        ranks = setup["meshed"][name]
        for key in ranks[0]:
            if key.startswith("cp/param/"):
                for r in ranks[1:]:
                    np.testing.assert_array_equal(r[key], ranks[0][key])


# ---------------------------------------------------------------- chain --


def _traj(root, name):
    rows = [json.loads(x) for x in (root / "logs" / f"{name}_metrics.jsonl").read_text().splitlines()]
    return rows


@pytest.mark.parametrize("task", ["cp", "cir"])
def test_meshed_chain_trajectory_matches_one_rank(setup, task):
    single = setup["single"]["chain"]
    meshed_root = setup["tmp"] / "fsdp" / "chain"
    want = _traj(single["root"], single[task])
    got = _traj(meshed_root, single[task])
    assert [(r["split"], r["epoch"]) for r in got] == [(r["split"], r["epoch"]) for r in want]
    for g, w in zip(got, want):
        for key in set(w) - {"split", "epoch", "epoch_seconds", "time"}:
            np.testing.assert_allclose(g[key], w[key], atol=1e-4, rtol=1e-4, err_msg=f"{w['split']} {w['epoch']} {key}")


def test_meshed_chain_fitb_and_checkpoints_read_by_jax(setup):
    """FITB over the meshed CIR checkpoint equals the one-rank chain's, and
    the JAX package restores the meshed checkpoints (whole trees, written
    by rank 0) with the one-rank chain's parameters."""
    single = setup["single"]["chain"]
    meshed = setup["meshed"]["fsdp"][0]
    assert meshed["chain/fitb"] == single["fitb"]
    assert meshed["chain/cp_bytes"] > 0
    meshed_root = setup["tmp"] / "fsdp" / "chain" / "ckpt"
    template = JaxModel(setup["cfg"]).init(jax.random.PRNGKey(0))
    for name, tag in ((single["cp"], "final"), (single["cir"], "best_recall@1")):
        restored = JaxCheckpoints(meshed_root, name).restore(tag)["params"]
        assert jax.tree.structure(restored) == jax.tree.structure(template)
        got = state_dict_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), restored))
        want = load_jax_checkpoint(single["root"] / "ckpt" / name / tag)
        for n in want:
            np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), atol=1e-4, rtol=1e-4, err_msg=n)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_jax_meshed_checkpoint_resumes_onto_shards(setup, name):
    """A JAX checkpoint of FSDP+TP-sharded parameters and its optax state
    resumes in the port's meshed trainer: each rank's live blocks of the
    parameters and of both Adam moments are its blocks of the trees."""
    d, m, fsdp = MESHES[name]
    want = load_jax_checkpoint(setup["jax_ckpt"])
    adam = JaxCheckpoints(setup["tmp"] / "jaxckpt", "meshed").restore("latest")["opt_state"][1][0]
    moments = {key: state_dict_from_jax(adam[i]) for i, key in ((1, "mu"), (2, "nu"))}
    cfg = port_config(setup["cfg"])

    def block(sd, rank):
        return shard_state_dict({k: v.numpy() for k, v in sd.items()}, cfg,
                                {DATA_AXIS: d, MODEL_AXIS: m}, (rank // m, rank % m), fsdp=fsdp)

    for rank, res in enumerate(setup["meshed"][name]):
        assert res["resume/epoch"] == 5
        assert res["resume/step"] == res["resume/count"] == 3
        for n, v in block(want, rank).items():
            np.testing.assert_array_equal(res[f"resume{rank}/{n}"], v)
            np.testing.assert_array_equal(res["resume/full/" + n], want[n].numpy())
        for key, sd in moments.items():
            mine = block(sd, rank)
            assert sorted(mine) == sorted(k[len(f"resume{rank}/{key}/"):] for k in res
                                          if k.startswith(f"resume{rank}/{key}/"))
            for n, v in mine.items():
                np.testing.assert_array_equal(res[f"resume{rank}/{key}/{n}"], v)


def test_block_attention_and_heads_fail_on_a_model_axis(tiny_cfg):
    """attn='block' has no tensor-parallel route (JAX routes the fused
    block on one device only), and the heads must divide the model axis."""
    import dataclasses

    from outfitx_tpu_torch.parallel import ParallelContext

    par = ParallelContext(
        data=1, model=2, fsdp=False, rank=0, position=(0, 0),
        device=torch.device("cpu"), backend="gloo", groups={},
    )
    cfg = port_config(tiny_cfg)
    with pytest.raises(ValueError, match="attn='block'"):
        OutfitXModel(cfg, device="cpu", attn="block").shard_(par)
    odd = dataclasses.replace(cfg, transformer=dataclasses.replace(cfg.transformer, n_heads=1))
    with pytest.raises(ValueError, match="n_heads 1 does not divide"):
        OutfitXModel(odd, device="cpu").shard_(par)
