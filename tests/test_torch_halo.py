"""The port's halo exchange (``ddlpc_tpu_torch/parallel/halo.py``) against
the JAX package's (``ddlpc_tpu/parallel/halo.py``, ``tests/test_halo.py``).

The port's ranks are gloo processes laid out as a process grid
(``tests/test_torch_grid_worker.py``); JAX runs ``halo_exchange`` inside
``shard_map`` on the virtual CPU mesh.  Tolerances:

- the exchanged rows bit for bit (a copy moves them on both sides);
- ``sharded_same_conv`` and its gradients (of ``sum(conv · w)`` for a
  seeded cotangent ``w``, the input's rows on each rank and the kernel's
  summed over the ranks) against the unsharded conv of
  ``lax.conv_general_dilated`` at rtol 1e-4 / atol 1e-6; the kernel's
  gradient, a sum over every output pixel whose terms cancel, at rtol
  1e-4 / atol 1e-5 (``tests/test_halo.py`` holds its convs at 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ddlpc_tpu.parallel.halo import halo_exchange as jhalo_exchange
from ddlpc_tpu.utils.compat import shard_map
from ddlpc_tpu_torch.parallel.halo import halo_exchange, sharded_same_conv
from test_torch_grid_worker import run_grid
from test_torch_threads import intra_op_threads

one_intra_op_thread = intra_op_threads(1)  # autouse

TOL = dict(rtol=1e-4, atol=1e-6)
KTOL = dict(rtol=1e-4, atol=1e-5)


def _jax_halo(x: np.ndarray, space: int, halo: int) -> np.ndarray:
    """JAX's exchange over a ``space``-way axis: each shard's padded rows,
    ``[space, N, H/space + 2·halo, W, C]``."""
    mesh = Mesh(np.array(jax.devices()[:space]).reshape(1, space), ("data", "space"))
    out = jax.jit(shard_map(
        lambda v: jhalo_exchange(v, "space", halo), mesh=mesh,
        in_specs=P(None, "space"), out_specs=P(None, "space"),
    ))(jnp.asarray(x))
    out = np.asarray(out)
    per = out.shape[1] // space
    return np.stack([out[:, s * per : (s + 1) * per] for s in range(space)])


def _jax_conv(x, k, w):
    def f(x, k):
        y = lax.conv_general_dilated(x, k, (1, 1), "SAME",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return (y * w).sum(), y

    (_, y), (gx, gk) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(k))
    return np.asarray(y), np.asarray(gx), np.asarray(gk)


_CASES = {}


def _space4(tmp_path_factory):
    """One world of space 4: the JAX test's 16 rows at halo 2, 12 rows (3
    a shard, odd) at halo 2, and a conv of 32 rows."""
    if "space4" not in _CASES:
        rng = np.random.default_rng(0)
        inputs = {
            "even/x": np.arange(2 * 16 * 3 * 4, dtype=np.float32).reshape(2, 16, 3, 4),
            "odd/x": rng.standard_normal((2, 12, 5, 3)).astype(np.float32),
            "conv/x": rng.normal(size=(2, 32, 16, 3)).astype(np.float32),
            "conv/k": rng.normal(size=(3, 3, 3, 5)).astype(np.float32),
            "conv/w": rng.normal(size=(2, 32, 16, 5)).astype(np.float32),
            "bf16/x": (np.arange(2 * 16 * 3 * 4) % 128).astype(np.float32).reshape(2, 16, 3, 4),
        }
        task = {"cases": [{"name": "even", "halo": 2}, {"name": "odd", "halo": 2},
                          {"name": "bf16", "halo": 2, "dtype": "bfloat16"},
                          {"name": "conv", "halo": 1, "conv": True}]}
        outs = run_grid("halo", (1, 1, 4), str(tmp_path_factory.mktemp("space4")), task, inputs)
        _CASES["space4"] = (inputs, outs)
    return _CASES["space4"]


@pytest.mark.parametrize("case", ["even", "odd", "bf16"])
def test_halo_exchange_rows_equal_jax_at_space_4(case, tmp_path_factory):
    """The rows, fp32 and (integers exact in) bfloat16, which crosses
    gloo as its int16 bits."""
    inputs, outs = _space4(tmp_path_factory)
    want = _jax_halo(inputs[f"{case}/x"], 4, 2)
    for s, out in enumerate(outs):
        np.testing.assert_array_equal(out[f"{case}/y"], want[s], err_msg=f"shard {s}")
    # Interior rows are the shard; the global edges are zeros.
    assert not outs[0][f"{case}/y"][:, :2].any() and not outs[3][f"{case}/y"][:, -2:].any()


def test_sharded_conv_and_its_gradient_equal_the_unsharded_conv(tmp_path_factory):
    inputs, outs = _space4(tmp_path_factory)
    y, gx, gk = _jax_conv(inputs["conv/x"], inputs["conv/k"], inputs["conv/w"])
    rows = 32 // 4
    for s, out in enumerate(outs):
        np.testing.assert_allclose(out["conv/conv"], y[:, s * rows : (s + 1) * rows], **TOL)
        np.testing.assert_allclose(out["conv/gx"], gx[:, s * rows : (s + 1) * rows], **TOL)
        np.testing.assert_allclose(out["conv/gk"], gk, **KTOL)


def test_halo_too_large_raises():
    with pytest.raises(ValueError, match="halo"):
        halo_exchange(torch.zeros(1, 2, 4, 2), 3, spatial_axis=1)
    with pytest.raises(ValueError, match="odd kernel"):
        sharded_same_conv(torch.zeros(1, 2, 4, 4), torch.zeros(3, 2, 2, 3))


def test_one_shard_is_zero_padding():
    """Without a space axis the exchange pads with zeros, and the sharded
    conv is the 'SAME' conv."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(1, 3, 6, 5)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(4, 3, 3, 3)).astype(np.float32))
    np.testing.assert_array_equal(halo_exchange(x, 1)[:, :, 1:-1], x)
    want = torch.nn.functional.conv2d(x, k, padding=1)
    np.testing.assert_allclose(sharded_same_conv(x, k), want, **TOL)


def test_halo_on_a_stage_sub_grid_and_across_a_stage_boundary(tmp_path_factory):
    """``tests/test_halo.py:201-271`` on the port: a (pipe 2 × data 2 ×
    space 2) grid; each stage's space groups run the sharded conv on H = 10
    (5 rows a shard, odd) and equal the unsharded conv; a carry exchanged
    on stage 0, sent to stage 1's rank of the same (data, space) position
    and exchanged there gives the same rows, bit for bit, which are JAX's."""
    rng = np.random.default_rng(0)
    inputs = {
        "stage/x": rng.standard_normal((2, 10, 8, 3)).astype(np.float32),
        "stage/k": (rng.standard_normal((3, 3, 3, 5)) * 0.1).astype(np.float32),
        "stage/w": rng.standard_normal((2, 10, 8, 5)).astype(np.float32),
        "carry/x": np.arange(2 * 12 * 3 * 2, dtype=np.float32).reshape(2, 12, 3, 2),
    }
    task = {"cases": [{"name": "stage", "halo": 1, "conv": True},
                      {"name": "carry", "carry": True}]}
    outs = run_grid("halo", (2, 2, 2), str(tmp_path_factory.mktemp("stages")), task, inputs)
    y, gx, gk = _jax_conv(inputs["stage/x"], inputs["stage/k"], inputs["stage/w"])
    want = _jax_halo(inputs["carry/x"], 2, 1)
    for r, out in enumerate(outs):
        p, d, s = r // 4, (r // 2) % 2, r % 2
        np.testing.assert_allclose(out["stage/conv"], y[:, 5 * s : 5 * s + 5], **TOL)
        np.testing.assert_allclose(out["stage/gx"], gx[:, 5 * s : 5 * s + 5], **TOL)
        np.testing.assert_allclose(out["stage/gk"], gk, **KTOL)
        np.testing.assert_array_equal(out["carry/y"], want[s], err_msg=f"rank {r}")
        np.testing.assert_array_equal(out["carry/y"], outs[(r + 4) % 8]["carry/y"])


@pytest.mark.parametrize("pipe,data,space", [(1, -1, 1), (1, 2, 4), (1, -1, 2), (2, -1, 2),
                                             (2, 2, 2), (2, 4, 1), (4, -1, 1)])
def test_grid_lays_ranks_out_as_make_mesh_lays_devices(pipe, data, space):
    """Global rank r of the port's grid sits at the mesh position of JAX's
    device r (``make_mesh`` over the 8 CPU devices, pipe outermost, space
    innermost)."""
    from ddlpc_tpu.config import ParallelConfig
    from ddlpc_tpu.parallel.mesh import make_mesh
    from ddlpc_tpu_torch.parallel import mesh

    jmesh = make_mesh(ParallelConfig(pipeline_stages=pipe, data_axis_size=data,
                                     space_axis_size=space))
    shape = mesh.grid_shape(8, pipe, data, space)
    devices = jmesh.devices.reshape(shape)
    grid = mesh.Grid(*shape, rank=0)
    for (p, d, s), dev in np.ndenumerate(devices):
        assert mesh.coords_of(dev.id, shape[1], shape[2]) == (p, d, s)
        assert grid.global_rank(p, d, s) == dev.id


@pytest.mark.parametrize("pipe,data,space", [(1, -1, 3), (3, -1, 1), (1, 16, 1), (2, 8, 1)])
def test_grid_refuses_what_make_mesh_refuses_in_its_words(pipe, data, space):
    from ddlpc_tpu.config import ParallelConfig
    from ddlpc_tpu.parallel.mesh import make_mesh
    from ddlpc_tpu_torch.parallel import mesh

    with pytest.raises(ValueError) as want:
        make_mesh(ParallelConfig(pipeline_stages=pipe, data_axis_size=data, space_axis_size=space))
    with pytest.raises(ValueError) as got:
        mesh.grid_shape(8, pipe, data, space)
    assert str(got.value) == str(want.value)
