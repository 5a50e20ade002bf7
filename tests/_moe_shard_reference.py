"""Reference side of ``test_torch_moe_shard.py``: the JAX package's
``moe_block_sharded`` and ``Model.loss`` with ``moe_impl="shard_map"`` on
host-CPU meshes, run as its own process.

Usage: ``python tests/_moe_shard_reference.py INPUTS.npz CASES.json
OUT.npz``.  The device count is fixed before jax is imported
(``--xla_force_host_platform_device_count=4``), so the meshes (1, 2),
(2, 1), (2, 2) and (1, 4) are made from the first devices; axes
("data", "model").  For each block case it writes the output, the aux
loss and ``jax.grad`` of ``loss = sum(out * r) + AUX_W * aux`` with
respect to x and every parameter; for each model case ``Model.loss`` on
the case's batch and, where asked, its gradient.  bf16 leaves are written
as float32 (exact).
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                           "--xla_force_host_platform_device_count=4").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax                                        # noqa: E402
import jax.numpy as jnp                           # noqa: E402
import numpy as np                                # noqa: E402
from jax.sharding import Mesh                     # noqa: E402

AUX_W = 0.37


def mesh_of(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        out[f"{prefix}/{key}"] = _np(leaf)
    return out


def block_case(inp, case):
    from repro.models.moe_shard import moe_block_sharded
    dt = jnp.bfloat16 if case["dtype"] == "bfloat16" else jnp.float32
    params = {"router": jnp.asarray(inp["router"], jnp.float32)}
    for k in ("w_gate", "w_up", "w_down"):
        params[k] = jnp.asarray(inp[k], dt)
    if case["shared"]:
        params["shared"] = {k: jnp.asarray(inp["shared_" + k], dt)
                            for k in ("w_gate", "w_up", "w_down")}
    x = jnp.asarray(inp["x"], dt)
    r = jnp.asarray(inp["r"], jnp.float32)
    mesh = mesh_of(case["mesh"])
    kw = dict(n_experts=case["n_experts"], top_k=case["top_k"], mesh=mesh,
              dp_axes=("data",), capacity_factor=case["capacity"])

    def loss(params, x):
        out, aux = moe_block_sharded(params, x, **kw)
        return jnp.sum(out.astype(jnp.float32) * r) + AUX_W * aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    res = {"out": _np(out), "aux": _np(aux), "grad/x": _np(gx)}
    res.update(_flat(gp, "grad"))
    return res


def model_case(case):
    from repro.configs import ARCHS
    from repro.data import SyntheticLMDataset
    from repro.models import build_model
    cfg = ARCHS[case["arch"]].smoke()
    model = build_model(cfg, dtype=jnp.float32, remat=False)
    mesh = mesh_of(case["mesh"])
    model.moe_impl = "shard_map"
    model.moe_mesh = mesh
    model.moe_dp_axes = ("data",)
    params = jax.jit(model.init)(jax.random.key(0))
    ds = SyntheticLMDataset(cfg.vocab, case["seq"], case["batch"])
    batch = {k: jnp.asarray(v) for k, v in ds.batch_at(0).items()}
    if not case["grads"]:
        return {"loss": _np(jax.jit(model.loss)(params, batch))}
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, batch)
    res = {"loss": _np(loss)}
    res.update(_flat(grads, "grad"))
    return res


def main():
    inp_path, cases_path, out_path = sys.argv[1:4]
    inp = dict(np.load(inp_path))
    with open(cases_path) as f:
        cases = json.load(f)
    out = {}
    for case in cases:
        res = (block_case(inp, case) if case["kind"] == "block"
               else model_case(case))
        out.update({f"{case['tag']}/{k}": v for k, v in res.items()})
    np.savez(out_path + ".tmp.npz", **out)
    os.replace(out_path + ".tmp.npz", out_path)


if __name__ == "__main__":
    main()
