"""sofima_tpu_torch.parallel against sofima_tpu.parallel (CPU, gloo ranks).

The port runs SPMD over processes: the cases run on 4 gloo ranks, each a
child process of this Python (`parallel.launch`, a FileStore rendezvous
under the test's temporary directory, one thread a rank), spawned once
by a module-scoped fixture that runs every case in one job. The
reference runs each case on 4 of this process's 8 virtual JAX devices
(`make_mesh(4)`, `make_mesh_2d(2, 2)`), meanwhile. The cases are those
of tests/test_parallel.py, on the same numpy inputs made from its seeds:
  * the sharded FIRE solve, 2d on a y split and on a 2 x 2 grid (18 x 14,
    NaN auto-pad on both axes), an indivisible y, auto-pad with drift
    removal, 3d on a y split and on a 2 x 2 grid, and with an injected
    `base_force` (`mesh.inplane_force_plain`): against the reference's
    sharded solve and the port's one-rank `relax_mesh_fused`, max |dx|
    < 1e-3 px (tests/test_parallel.py's bar) with equal NaN patterns and,
    against the port, equal steps;
  * the halo-exchanged force against the whole force, atol 1e-5;
  * `sharded_flow_step` and `dense_flow_field_sharded` (padfield,
    circular, an unaligned height, a masked band across the strip
    boundaries): integer x/y peaks and NaN placement exact against both,
    sharpness and ratio within rtol = atol = 3e-4.
Every rank must return the same global result. Also: a one-rank mesh
(no process group) against `relax_mesh_fused` bit for bit, FIRE=False
raising, `_make_step_fns`'s default hooks, tests/test_aux.py's
TestDistributed, `initialize` refusing NCCL without a card, and
`process_volume_distributed` on 2 gloo ranks into one TensorStore volume
against one-process `runner.process_volume` and against the reference's
two-process run of tests/distributed_worker.py's `double` mode.
"""

import concurrent.futures
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sofima_tpu_torch import flow_field as tff
from sofima_tpu_torch import mesh as tmesh
from sofima_tpu_torch.parallel import distributed as tdist
from sofima_tpu_torch.parallel import launch
from sofima_tpu_torch.parallel import mesh_sharding as tms
from sofima_tpu_torch.processor import runner as trunner
from sofima_tpu_torch.utils.bounding_box import BoundingBox as TBox
from sofima_tpu_torch.utils.volume import InMemoryVolume, TensorStoreVolume

torch.set_num_threads(2)
RANKS = 4
MESH_TOL = 1e-3
FORCE_TOL = 1e-5
STAT_TOL = 3e-4

# name -> (seed, shape, device mesh, dim, config changes, drift prev)
SOLVES = {
    '2d': (0, (2, 1, 16, 12), (4,), 2, {}, False),
    '2d_grid': (7, (2, 1, 18, 14), (2, 2), 2, {}, False),
    'indivisible_y': (5, (2, 1, 18, 12), (4,), 2, {}, False),
    'autopad_drift': (11, (2, 1, 18, 12), (4,), 2,
                      dict(remove_drift=True), True),
    '3d': (1, (3, 4, 8, 6), (4,), 3, dict(stride=(40, 40, 40)), False),
    '3d_grid': (13, (3, 4, 10, 14), (2, 2), 3, dict(stride=(40, 40, 40)),
                False),
    'injected_force': (5, (2, 1, 16, 8), (4,), 2,
                       dict(num_iters=100, max_iters=2000), False),
}
# The 3d solves take as long on the reference's virtual devices as the
# rest together: tests/test_torch_parallel3d.py holds them.
SOLVES_2D = tuple(n for n in SOLVES if SOLVES[n][3] == 2)
SOLVES_3D = tuple(n for n in SOLVES if SOLVES[n][3] == 3)
# name -> (seed, height, mode, masked)
FLOWS = {
    'padfield': (1, 160, 'padfield', False),
    'circular': (1, 160, 'circular', False),
    'unaligned': (3, 150, 'padfield', False),
    'masked': (2, 160, 'circular', True),
}
PATCH, STEP = (40, 40), (10, 10)


def _config_kwargs(changes):
  kw = dict(dt=0.001, gamma=0.0, k0=0.05, k=0.1, stride=(40, 40),
            num_iters=200, max_iters=20000, stop_v_max=0.001, dt_max=100.0)
  kw.update(changes)
  return kw


def _solve_inputs(name):
  seed, shape, _, _, _, drift = SOLVES[name]
  rng = np.random.RandomState(seed)
  x = rng.randn(*shape).astype(np.float32)
  prev = (x + rng.randn(*shape).astype(np.float32) * 0.1 if drift
          else np.zeros_like(x))
  return x, prev


def _flow_inputs(name):
  seed, h, _, masked = FLOWS[name]
  rng = np.random.RandomState(seed)
  noise = rng.rand(h, 128).astype(np.float32)
  f = np.fft.rfft2(noise)
  fy = np.fft.fftfreq(h)[:, None]
  fx = np.fft.rfftfreq(128)[None, :]
  f *= np.exp(-((fx**2 + fy**2) / (2 * 0.1**2)))
  pre = np.fft.irfft2(f, s=(h, 128)).astype(np.float32)
  post = np.roll(pre, (2, -1) if name == 'unaligned' else (3, -2), (0, 1))
  mask = None
  if masked:
    mask = np.zeros(pre.shape, bool)
    mask[40:70, :] = True  # an invalid band across the strip boundaries
  return pre, post, mask


def _flow_kwargs(name):
  _, _, mode, _ = FLOWS[name]
  return dict(batch_size=64, circular=mode == 'circular')


def _flow_step_inputs():
  rng = np.random.RandomState(0)
  img = rng.rand(64, 64).astype(np.float32)
  post = np.roll(img, (2, -1), (0, 1))
  starts = np.array([[y * 8, x * 8] for y in range(4) for x in range(4)],
                    np.int32)
  return img, post, starts


def _port_mesh(shape):
  return (tms.make_mesh(shape[0]) if len(shape) == 1
          else tms.make_mesh_2d(*shape))


def _rank_cases(solves, others=True):
  """The solves `solves` and, with `others`, every other case on this rank
  of the 4-rank job -> {name: numpy result}."""
  out = {}
  for name in solves:
    _, _, shape, dim, changes, _ = SOLVES[name]
    x, prev = _solve_inputs(name)
    cfg = tmesh.IntegrationConfig(**_config_kwargs(changes))
    base = tmesh.inplane_force_plain if name == 'injected_force' else None
    got, e_hist, steps = tms.relax_mesh_sharded(
        x, prev, cfg, _port_mesh(shape), dim=dim, base_force=base,
        device='cpu')
    out[name] = (got.numpy(), e_hist.numpy(), steps)
  if not others:
    return out
  # The injected force's partner: the same solve with the default force.
  x, prev = _solve_inputs('injected_force')
  cfg = tmesh.IntegrationConfig(**_config_kwargs(SOLVES['injected_force'][4]))
  out['injected_force_default'] = tms.relax_mesh_sharded(
      x, prev, cfg, tms.make_mesh(RANKS), device='cpu')[0].numpy()

  # The halo-exchanged force on this rank's rows, gathered.
  x = torch.from_numpy(np.random.RandomState(2).randn(2, 1, 16, 8)
                       .astype(np.float32))
  dmesh = tms.make_mesh(RANKS, 'my')
  rows = 16 // RANKS
  i = dmesh.coords[0]
  f = tms._sharded_force_2d(dmesh.axis('my'))(
      x[..., i * rows:(i + 1) * rows, :].contiguous(), 0.1, (40, 40))
  out['halo_force'] = torch.cat(tms._all_gather(
      f, dmesh.group, dmesh.size), dim=-2).numpy()

  img, post, starts = _flow_step_inputs()
  run = tms.sharded_flow_step(tms.make_mesh(RANKS, 'mesh_y'), 'mesh_y',
                              device='cpu')
  out['flow_step'] = run(img, post, starts, (24, 24)).numpy()

  for name in FLOWS:
    pre, post, mask = _flow_inputs(name)
    kw = _flow_kwargs(name)
    if mask is not None:
      kw['pre_mask'] = mask
    out['flow_' + name] = tms.dense_flow_field_sharded(
        tms.make_mesh(RANKS, 'mesh_y'), pre, post, PATCH, STEP, device='cpu',
        **kw).numpy()
  return out


def _reference_cases(solves, others=True):
  """The reference's sharded runs of the same cases on this process's
  virtual devices."""
  import jax.numpy as jnp
  from sofima_tpu import mesh as jmesh
  from sofima_tpu.parallel import mesh_sharding as jms
  from jax.sharding import PartitionSpec as P

  out = {}
  for name in solves:
    _, _, shape, dim, changes, _ = SOLVES[name]
    x, prev = _solve_inputs(name)
    dmesh = (jms.make_mesh(shape[0]) if len(shape) == 1
             else jms.make_mesh_2d(*shape))
    got, e_hist, steps = jms.relax_mesh_sharded(
        jnp.asarray(x), jnp.asarray(prev),
        jmesh.IntegrationConfig(**_config_kwargs(changes)), dmesh, dim=dim)
    out[name] = (np.asarray(got), np.asarray(e_hist), int(steps))
  if not others:
    return out

  x = np.random.RandomState(2).randn(2, 1, 16, 8).astype(np.float32)
  force = jms._sharded_force_2d('my')
  out['halo_force'] = np.asarray(jms.shard_map(
      lambda xl: force(xl, 0.1, (40, 40)), mesh=jms.make_mesh(RANKS, 'my'),
      in_specs=P(None, None, 'my', None),
      out_specs=P(None, None, 'my', None))(jnp.asarray(x)))

  img, post, starts = _flow_step_inputs()
  run = jms.sharded_flow_step(jms.make_mesh(RANKS, 'mesh_y'), 'mesh_y')
  out['flow_step'] = np.asarray(run(jnp.asarray(img), jnp.asarray(post),
                                    jnp.asarray(starts), (24, 24)))

  for name in FLOWS:
    pre, post, mask = _flow_inputs(name)
    kw = _flow_kwargs(name)
    if mask is not None:
      kw['pre_mask'] = mask
    out['flow_' + name] = np.asarray(jms.dense_flow_field_sharded(
        jms.make_mesh(RANKS, 'mesh_y'), pre, post, PATCH, STEP, **kw))
  return out


def _one_rank(name):
  """The port's one-rank result of a case."""
  if name in SOLVES:
    x, prev = _solve_inputs(name)
    cfg = tmesh.IntegrationConfig(**_config_kwargs(SOLVES[name][4]))
    force = (tmesh.inplane_force if SOLVES[name][3] == 2
             else tmesh.elastic_mesh_3d)
    got, e_hist, steps = tmesh.relax_mesh_fused(
        torch.from_numpy(x), torch.from_numpy(prev), cfg, mesh_force=force)
    return got.numpy(), e_hist.numpy(), steps
  if name == 'halo_force':
    x = np.random.RandomState(2).randn(2, 1, 16, 8).astype(np.float32)
    return tmesh.inplane_force(torch.from_numpy(x), 0.1, (40, 40)).numpy()
  if name == 'flow_step':
    img, post, starts = _flow_step_inputs()
    return tff.batched_xcorr_peaks(
        torch.from_numpy(img), torch.from_numpy(post), None, None, (24, 24),
        torch.from_numpy(starts).long(), mean=None).numpy()
  pre, post, mask = _flow_inputs(name[len('flow_'):])
  kw = _flow_kwargs(name[len('flow_'):])
  if mask is not None:
    kw['pre_mask'] = torch.from_numpy(mask)
  return tff.dense_flow_field(torch.from_numpy(pre), torch.from_numpy(post),
                              PATCH, STEP, **kw).numpy()


def run_cases(workdir, solves, others=True):
  """(each rank's results, the reference's): the port's 4-rank job runs
  while this process computes the reference's, one case at a time
  (concurrent multi-device programs on the virtual devices are not
  safe)."""
  with concurrent.futures.ThreadPoolExecutor(1) as pool:
    job = pool.submit(launch.run, f'{__file__}:_rank_cases', RANKS, 'gloo',
                      args=(solves, others), workdir=workdir, timeout=240)
    ref = _reference_cases(solves, others)
    return job.result(), ref


@pytest.fixture(scope='module')
def results(tmp_path_factory):
  return run_cases(tmp_path_factory.mktemp('ranks'), SOLVES_2D)


def _assert_mesh_close(got, ref):
  assert got.shape == ref.shape
  np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
  np.testing.assert_allclose(got, ref, atol=MESH_TOL, rtol=0,
                             equal_nan=True)


def _assert_flow_equal(got, ref):
  """Channels first: x/y peaks and NaN exact, statistics within STAT_TOL."""
  assert got.shape == ref.shape
  np.testing.assert_array_equal(np.nan_to_num(got[:2], nan=9e9),
                                np.nan_to_num(ref[:2], nan=9e9))
  np.testing.assert_allclose(got[2:], ref[2:], rtol=STAT_TOL, atol=STAT_TOL,
                             equal_nan=True)


def test_every_rank_returns_the_global_result(results):
  ranks, _ = results
  for other in ranks[1:]:
    assert other.keys() == ranks[0].keys()
    for name, value in ranks[0].items():
      parts = value if isinstance(value, tuple) else (value,)
      for a, b in zip(parts, other[name]
                      if isinstance(value, tuple) else (other[name],)):
        np.testing.assert_array_equal(a, b, err_msg=name)


def check_solve_against_reference(results, name):
  ranks, ref = results
  got, e_hist, _ = ranks[0][name]
  _assert_mesh_close(got, ref[name][0])
  assert np.isfinite(e_hist[0])


def check_solve_against_one_rank(results, name):
  ranks, _ = results
  got, e_hist, steps = ranks[0][name]
  one, one_hist, one_steps = _one_rank(name)
  print(f'{name}: steps {steps} sharded, {one_steps} one rank')
  assert steps == one_steps
  _assert_mesh_close(got, one)
  assert e_hist.shape == one_hist.shape


@pytest.mark.parametrize('name', SOLVES_2D)
def test_solve_matches_reference_sharded(results, name):
  check_solve_against_reference(results, name)


@pytest.mark.parametrize('name', SOLVES_2D)
def test_solve_matches_one_rank(results, name):
  check_solve_against_one_rank(results, name)


def test_injected_force_matches_default(results):
  ranks, _ = results
  got = ranks[0]['injected_force'][0]
  np.testing.assert_allclose(got, ranks[0]['injected_force_default'],
                             atol=MESH_TOL, rtol=0)


@pytest.mark.parametrize('against', ['reference', 'one_rank'])
def test_halo_force_equivalence(results, against):
  ranks, ref = results
  want = ref['halo_force'] if against == 'reference' else _one_rank(
      'halo_force')
  np.testing.assert_allclose(ranks[0]['halo_force'], want, atol=FORCE_TOL,
                             rtol=0)


@pytest.mark.parametrize('against', ['reference', 'one_rank'])
def test_sharded_flow_step(results, against):
  ranks, ref = results
  got = ranks[0]['flow_step']
  want = ref['flow_step'] if against == 'reference' else _one_rank(
      'flow_step')
  assert got.shape == (16, 4)
  _assert_flow_equal(got.T, want.T)
  valid = np.isfinite(got[:, 0])
  assert valid.any()
  np.testing.assert_array_equal(got[valid, 0], 1.0)
  np.testing.assert_array_equal(got[valid, 1], -2.0)


@pytest.mark.parametrize('name', sorted(FLOWS))
def test_dense_flow_matches_reference_sharded(results, name):
  ranks, ref = results
  _assert_flow_equal(ranks[0]['flow_' + name], ref['flow_' + name])


@pytest.mark.parametrize('name', sorted(FLOWS))
def test_dense_flow_matches_one_rank(results, name):
  ranks, _ = results
  got = ranks[0]['flow_' + name]
  _assert_flow_equal(got, _one_rank('flow_' + name))
  if name in ('padfield', 'circular'):
    # The known roll is recovered in the interior.
    assert np.nanmedian(got[0][2:-2, 2:-2]) == 2.0


@pytest.mark.parametrize('name', ['2d', 'autopad_drift'])
def test_one_rank_mesh_equals_relax_mesh_fused(name):
  check_one_rank_mesh(name)


def check_one_rank_mesh(name):
  # Without a process group the mesh is this process: NaN halos, no
  # collectives, the same bits as the unsharded solver.
  assert not dist.is_initialized()
  x, prev = _solve_inputs(name)
  cfg = tmesh.IntegrationConfig(**_config_kwargs(SOLVES[name][4]))
  dim = SOLVES[name][3]
  got, e_hist, steps = tms.relax_mesh_sharded(
      x, prev, cfg, tms.make_mesh(), dim=dim, device='cpu')
  one, one_hist, one_steps = _one_rank(name)
  assert steps == one_steps
  np.testing.assert_array_equal(got.numpy(), one)
  np.testing.assert_allclose(e_hist.numpy(), one_hist, rtol=1e-6)


def test_sharded_solve_requires_fire():
  x, prev = _solve_inputs('2d')
  cfg = tmesh.IntegrationConfig(**_config_kwargs(dict(fire=False)))
  with pytest.raises(NotImplementedError):
    tms.relax_mesh_sharded(x, prev, cfg, tms.make_mesh(), device='cpu')


def test_step_fns_default_hooks_keep_the_bits():
  # The identity and the NaN-aware mean are the defaults: a FIRE chunk
  # with drift removal gives the same bits with the hooks passed
  # explicitly and left out.
  x, prev = (torch.from_numpy(a) for a in _solve_inputs('autopad_drift'))
  x[..., 3, 4] = float('nan')
  cfg = tmesh.IntegrationConfig(**_config_kwargs(dict(remove_drift=True)))
  cap = torch.tensor(cfg.start_cap)
  runs = []
  for hooks in ({}, dict(reduce_fn=lambda v: v, mean_fn=tmesh._nanmean)):
    force, _, fire_step = tmesh._make_step_fns(cfg, tmesh.inplane_force,
                                               **hooks)
    state = tmesh.fire_state0(x, force(x, prev, cap), cfg)
    for _ in range(50):
      state = fire_step(state, prev)
    runs.append(state)
  for a, b in zip(*runs):
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_make_mesh_shapes():
  m = tms.make_mesh()
  assert m.axis_names == ('mesh_y',) and m.shape['mesh_y'] == 1
  m2 = tms.make_mesh_2d(1, 1, 'a', 'b')
  assert m2.shape == {'a': 1, 'b': 1} and m2.coords == (0, 0)
  with pytest.raises(ValueError):
    tms.make_mesh(2)  # one process: no second rank


class TestDistributed:
  """tests/test_aux.py's TestDistributed, on the port."""

  def test_partition_work(self):
    boxes = [TBox(start=(i, 0, 0), size=(1, 1, 1)) for i in range(10)]
    parts = [tdist.partition_work(boxes, num_parts=3, part_index=i)
             for i in range(3)]
    assert sum(len(p) for p in parts) == 10
    assert len({id(b) for part in parts for b in part}) == 10

  def test_single_process_noop(self):
    tdist.initialize(num_processes=1)
    assert not dist.is_initialized()
    assert tdist.process_count() == 1 and tdist.process_index() == 0
    tdist.barrier()

  def test_device_mesh(self):
    m = tdist.device_mesh(('a',))
    assert 'a' in m.shape

  def test_nccl_without_a_card_raises(self):
    if torch.cuda.is_available():
      pytest.skip('a machine without a card')
    with pytest.raises(RuntimeError, match='gloo'):
      tdist.initialize(coordinator_address='localhost:1', num_processes=2,
                       process_id=0, backend='nccl')
    assert not dist.is_initialized()


def _doubling_data():
  return np.random.RandomState(0).rand(1, 2, 40, 40).astype(np.float32)


def _doubler():
  class Doubler(trunner.SubvolumeProcessor):

    def process(self, subvol):
      return trunner.Subvolume(subvol.data * 2, subvol.bbox)
  return Doubler()


def _rank_double(out_path):
  """tests/distributed_worker.py's `double` mode on the port: the rank
  has joined through `initialize` (the launcher's), rank 0 makes the
  shared TensorStore volume and every rank writes its share."""
  assert tdist.process_count() == 2
  if tdist.process_index() == 0:
    TensorStoreVolume.create(out_path, (1, 2, 40, 40), np.float32,
                             chunk_size=(1, 1, 16, 16))
  tdist.barrier('created')
  out_vol = TensorStoreVolume.open(out_path)
  from sofima_tpu_torch.utils import metrics
  tdist.process_volume_distributed(
      _doubler(), InMemoryVolume(_doubling_data(), fill_value=0.0),
      output_volume=out_vol, subvolume_size=(16, 16, 2))
  done = metrics.registry().get_counter('Doubler', 'subvolumes-done')
  return done, out_vol[(slice(None),) * 4]


@pytest.fixture(scope='module')
def doubled(tmp_path_factory):
  """(each port rank's (boxes done, volume read after its barrier), the
  reference workers' volume): both two-process runs at once."""
  workdir = tmp_path_factory.mktemp('double')
  ref_dir = workdir / 'reference'
  ref_dir.mkdir()
  with socket.socket() as s:
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
  worker = os.path.join(os.path.dirname(__file__), 'distributed_worker.py')
  logs = [tempfile.TemporaryFile('w+') for _ in range(2)]
  procs = [subprocess.Popen(
      [sys.executable, worker, f'localhost:{port}', '2', str(i),
       str(ref_dir)], stdout=log, stderr=subprocess.STDOUT)
      for i, log in enumerate(logs)]
  try:
    ranks = launch.run(f'{__file__}:_rank_double', 2, 'gloo',
                       args=(str(workdir / 'out'),), workdir=workdir,
                       timeout=120)
    # The first worker to fail stops both: its peer would otherwise wait
    # out its coordinator.
    failure = launch._wait(procs, time.monotonic() + 120)
  finally:
    launch._stop(procs)
  outs = []
  for log in logs:
    log.seek(0)
    outs.append(log.read())
    log.close()
  assert failure is None, (failure, outs)
  assert 'DISTRIBUTED_OK' in outs[0], outs[0]
  from sofima_tpu.utils.volume import TensorStoreVolume as JTSVolume
  ref = JTSVolume.open(str(ref_dir / 'out'))[(slice(None),) * 4]
  return ranks, ref


def test_process_volume_distributed_matches_one_process(doubled):
  ranks, _ = doubled
  data = _doubling_data()
  one = trunner.process_volume(_doubler(), InMemoryVolume(
      data, fill_value=0.0), subvolume_size=(16, 16, 2))
  for done, vol in ranks:
    assert done > 0  # both ranks took a share
    np.testing.assert_array_equal(vol, one.data)
  np.testing.assert_allclose(one.data, data * 2, atol=1e-6)


def test_process_volume_distributed_matches_reference(doubled):
  ranks, ref = doubled
  np.testing.assert_array_equal(ranks[0][1], ref)
