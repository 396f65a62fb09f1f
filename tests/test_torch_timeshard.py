"""The port's time-sharded front end (``parallel/timeshard.py``: CFO with
the global sample index, decimating FIR with the right neighbour's halo,
OFDM demod) against the JAX package's ``sharded_frontend`` on the same mesh
size, in the two cases of tests/test_distributed_dsp.py, at its tolerance
(atol 2e-3: the JAX side demodulates through its matmul DFT). As there, the
last rank's decimated block is left out of the decimation case. The port's
sharded result is also held to its own unsharded front end at float32
rounding. The port's ranks are spawned gloo CPU processes."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from srsue_tpu.parallel import timeshard as ref_timeshard
from srsue_tpu.parallel.mesh import make_mesh as ref_make_mesh
from srsue_tpu.phy.cell import Cell
from srsue_tpu.utils.jaxutil import to_host_complex
from srsue_tpu_torch.parallel import mesh, ranks
from srsue_tpu_torch.phy import cell as port_cell
from srsue_tpu_torch.phy import ofdm, sync

CASES = {  # cell, subframes per rank, seed, decim, cfo
    "cfo": (Cell(n_prb=6, cell_id=5), 2, 0, 1, 0.11),
    "decimation_halo": (Cell(n_prb=50, cell_id=5), 1, 1, 1024 // 128, 0.0),
}


def _port_unsharded(cell, iq, n_sf, decim, cfo):
    x = torch.as_tensor(iq)
    if cfo:
        n = torch.arange(len(iq), dtype=torch.float64)
        x = x * torch.polar(torch.ones_like(n), -2.0 * np.pi * cfo / cell.nfft * n).to(
            torch.complex64)
    out_cell = cell
    if decim > 1:
        x = sync.decimate(x, decim)
        out_cell = port_cell.Cell(n_prb=6, cell_id=cell.cell_id)
    return ofdm.demodulate(out_cell, x.reshape(-1, out_cell.sf_len)).numpy()


def _stream(name, n):
    cell, n_sf, seed, _, _ = CASES[name]
    rng = np.random.default_rng(seed)
    total = n * n_sf * cell.sf_len
    return (rng.standard_normal(total) + 1j * rng.standard_normal(total)).astype(np.complex64)


@functools.cache
def _port_sharded(n):
    """{case: each rank's result} of the port's front end on n spawned ranks,
    every case in one launch (one spawn per world size)."""
    calls = [(ranks.frontend, (port_cell.Cell(**dataclasses.asdict(cell)), _stream(name, n),
                               n_sf, decim, cfo), {})
             for name, (cell, n_sf, _, decim, cfo) in CASES.items()]
    return dict(zip(CASES, zip(*mesh.launch(ranks.steps, n, "cpu", *calls))))


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("n", [4, pytest.param(2, marks=pytest.mark.slow)])
def test_timeshard_matches_reference(name, n):
    cell, n_sf, _, decim, cfo = CASES[name]
    iq = _stream(name, n)

    run, in_shard, ref_out_cell = ref_timeshard.sharded_frontend(
        cell, ref_make_mesh(n, axis="time"), n_sf, decim=decim, cfo=cfo)
    ref = to_host_complex(run(jax.device_put(iq, in_shard)))

    pcell = port_cell.Cell(**dataclasses.asdict(cell))
    out = _port_sharded(n)[name]
    got = np.concatenate([o["grids"] for o in out])
    assert {o["n_prb"] for o in out} == {ref_out_cell.n_prb}
    assert got.shape == ref.shape
    keep = len(got) - (n_sf if decim > 1 else 0)
    np.testing.assert_allclose(got[:keep], ref[:keep], atol=2e-3)
    mine = _port_unsharded(pcell, iq, n_sf, decim, cfo)
    np.testing.assert_allclose(got, mine, rtol=1e-5, atol=1e-5 * np.abs(mine).max())
