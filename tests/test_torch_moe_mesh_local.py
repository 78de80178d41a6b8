"""The local MoE path inside the port's sharded train step, where the
"model" axis does not divide the expert count (8 experts of
``get_smoke_config("moonshot-v1-16b-a3b")`` over model = 3): the rules
leave the expert leaves whole, every rank of "model" computes every expert,
and the reference's jitted step routes the whole batch at once.  So the port
gathers the tokens over the batch axes before routing (capacity, drops and
the aux loss are the whole batch's), and its global norm counts each expert
element once.  3 and 6 gloo ranks (``torch_mesh_ranks.spawn``) against the
reference on as many forced host devices, 3 steps from the same parameters.

Tolerances as in ``test_torch_moe_ep.py``: loss, ce, aux, gnorm, lr rtol
1e-5 at every step and identical on every rank; parameters atol 2e-5 after
step 3; each rank's expert ids and positions identical to the reference's
whole batch's.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_ranks as ranks
from repro_torch.configs.registry import get_smoke_config

ARCH = "moonshot-v1-16b-a3b"
STEP_TOL, PARAM_ATOL = 1e-5, 2e-5


@pytest.mark.parametrize("mesh", [(1, 3), (2, 3)])
def test_local_step_matches_reference_where_model_does_not_divide_experts(mesh, tmp_path):
    out = ranks.run_parity(ARCH, mesh, tmp_path)
    ranks.check_parity(out, step_tol=STEP_TOL, param_atol=PARAM_ATOL)
    T = ranks.BATCH * ranks.SEQ
    K = get_smoke_config(ARCH).experts_per_token
    assert all(r["routes"][0][0].shape == (T * K,) for r in out["port"])
