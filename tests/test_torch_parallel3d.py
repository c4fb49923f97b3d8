"""The 3d cases of tests/test_torch_parallel.py: the sharded 26-neighbour
FIRE solve on 4 gloo ranks, on a y split (3 x 4 x 8 x 6) and on a 2 x 2
grid (3 x 4 x 10 x 14, NaN auto-pad on both axes), against the
reference's sharded solve on 4 virtual JAX devices and the port's
one-rank `relax_mesh_fused` (max |dx| < 1e-3 px; equal steps against the
port), and a one-rank mesh against `relax_mesh_fused` bit for bit. A
file of their own: on the reference's virtual devices they take as long
as every other case of that file together.
"""

import pytest

import test_torch_parallel as tp


@pytest.fixture(scope='module')
def results(tmp_path_factory):
  return tp.run_cases(tmp_path_factory.mktemp('ranks3d'), tp.SOLVES_3D,
                      others=False)


def test_every_rank_returns_the_global_result(results):
  tp.test_every_rank_returns_the_global_result(results)


@pytest.mark.parametrize('name', tp.SOLVES_3D)
def test_solve_matches_reference_sharded(results, name):
  tp.check_solve_against_reference(results, name)


@pytest.mark.parametrize('name', tp.SOLVES_3D)
def test_solve_matches_one_rank(results, name):
  tp.check_solve_against_one_rank(results, name)


def test_one_rank_mesh_equals_relax_mesh_fused():
  tp.check_one_rank_mesh('3d')
