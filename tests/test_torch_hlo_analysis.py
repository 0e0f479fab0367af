"""The planning run's op walker (``launch.hlo_analysis``): its counts on
known ops, its roofline terms, and the collective census of a planned
train step against the census of the same step run in four gloo ranks.
"""
import json
import tempfile
import warnings

import pytest

torch = pytest.importorskip("torch")

from tests._torch_ranks import Job  # noqa: E402

LM_CELL = dict(kind="train", seq_len=64, global_batch=8)

_RANKS = f"""
import json
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import registry
from repro_torch.distributed import collectives as C
from repro_torch.launch.cells import _opt_cfg_for
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as tr
from repro_torch.models.sharding import lm_rules
from repro_torch.train.optimizer import init_state
from repro_torch.train.train_step import build_train_step
CELL = json.loads({json.dumps(LM_CELL)!r})
mesh = make_host_mesh((2, 2), ("data", "model"), device="cpu")
rules = lm_rules(mesh)
cfg = registry.get("qwen2-1.5b").make_reduced()
params = tr.init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu").tree()
sp = tr.shard_params(params, tr.param_shardings(cfg, rules))
opt_cfg = _opt_cfg_for(cfg)
state = init_state(opt_cfg, sp)
B, S = CELL["global_batch"], CELL["seq_len"]
toks = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator()
                     .manual_seed(1), dtype=torch.int32)
_, placements = rules.named_sharding("batch", None, shape=(B, S))
toks = distribute_tensor(toks, mesh, placements, src_data_rank=None)
step = build_train_step(lambda p, b: tr.lm_loss(p, b, cfg, rules), opt_cfg)
C.census.reset()
step(sp, state, toks)
if RANK == 0:
    np.savez(OUT, census=np.array(json.dumps(C.census.snapshot())))
"""


@pytest.fixture
def fake():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


def test_matmul_flops_and_bytes_are_exact(fake):
    """A fake [M, K] @ [K, N]: 2·M·N·K flops and the operands' plus the
    result's bytes, one op; nothing alive beyond the operands and the
    result."""
    from repro_torch.launch import hlo_analysis as ha

    M, K, N = 96, 40, 24
    with fake:
        a = torch.empty((M, K), dtype=torch.bfloat16)
        b = torch.empty((K, N), dtype=torch.bfloat16)
    plan = ha.analyze(lambda x, y: x @ y, (a, b), fake)
    assert plan.costs.flops == 2 * M * N * K
    assert plan.costs.hbm_bytes == 2 * (M * K + K * N + M * N)
    assert plan.ops == 1 and tuple(plan.outputs.shape) == (M, N)
    assert plan.memory["argument_bytes"] == 2 * (M * K + K * N)
    assert plan.memory["output_bytes"] == 2 * M * N
    assert plan.memory["peak_estimate_bytes"] == 2 * (M * K + K * N + M * N)


def test_walker_counts_pointwise_views_and_peak(fake):
    """A pointwise op counts one flop an output element, a view none and
    moves nothing; a temporary freed before the next one is allocated
    leaves the peak at one temporary over the argument (plus the few
    0-dim results alive beside it)."""
    from repro_torch.launch import hlo_analysis as ha

    def fn(x):
        y = (x * 2).sum()            # [n] temporary, freed after the sum
        z = (x + 1).view(-1, 4)      # another [n] temporary, a view of it
        return y + z.sum()

    with fake:
        x = torch.empty(1024)
    plan = ha.analyze(fn, (x,), fake)
    assert plan.costs.flops == 1024 * 4 + 1
    assert 4096 * 2 < plan.memory["peak_estimate_bytes"] <= 4096 * 2 + 16
    assert plan.costs.flops_by_op["aten.mul"] == 1024


def test_roofline_terms_use_the_h100_datasheet():
    """flops over 989 TFLOP/s, bytes over 3.35 TB/s, wire bytes over
    NVLink's 450 GB/s inside a node and 50 GB/s across nodes."""
    from repro_torch.launch import hlo_analysis as ha

    c = ha.Costs(flops=989e12, hbm_bytes=6.7e12, collective_bytes=0,
                 collective_counts={}, per_collective_bytes={},
                 link_bytes={"nvlink": 450e9, "ib": 100e9},
                 kernel_launches={}, kernel_flops={}, flops_by_op={})
    t = ha.roofline_terms(c)
    assert t["t_compute"] == pytest.approx(1.0)
    assert t["t_memory"] == pytest.approx(2.0)
    assert t["t_collective"] == pytest.approx(3.0)
    assert t["dominant"] == "collective"


def test_peak_with_margin_against_the_card():
    """A planned peak is held against the card 3.5% up (the planner's
    largest under-read on the card) plus 2 GiB kept back: 78.80 GiB a rank
    (DimeNet ``ogb_products`` on 256 ranks) does not fit the card's 79.18
    GiB, 70 GiB does."""
    from repro_torch.launch import hlo_analysis as ha

    GiB = 2**30
    assert ha.peak_with_margin(0) == 2 * GiB
    assert ha.peak_with_margin(78.80 * GiB) > ha.CARD_TOTAL_MEMORY
    assert ha.peak_with_margin(70 * GiB) <= ha.CARD_TOTAL_MEMORY


def test_ring_wire_bytes_and_links():
    """Wire bytes by ring factors over each mesh dim of rank 0's group,
    and the link by whether the group stays inside a node of 8."""
    from repro_torch.launch import hlo_analysis as ha

    assert ha._wire("all_gather", 4, 400) == 300
    assert ha._wire("reduce_scatter", 4, 100) == 300
    assert ha._wire("all_reduce", 4, 400) == 600
    assert ha._wire("all_reduce", 1, 400) == 0
    assert ha._link([0, 1, 2, 7]) == "nvlink" and ha._link([0, 16]) == "ib"


def test_group_over_several_axes_is_priced_as_one_group():
    """A collective over (data, model) is one group of both dims' ranks:
    on a (16, 4) mesh its model dim stays inside a node, but the group of
    64 spans nodes, so its ring has 64 ranks and its bytes go over
    InfiniBand."""
    import types

    from repro_torch.launch import hlo_analysis as ha

    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 mesh=torch.arange(64).reshape(16, 4))
    assert ha._group_ranks(mesh, ["data", "model"]) == list(range(64))
    census = {"all_reduce[data,model]": {"calls": 1, "bytes": 640},
              "all_gather[model]": {"calls": 2, "bytes": 400}}
    counts, wire, link = ha._collective_costs(mesh, census, None, 1)
    assert counts == {"all_reduce[data,model]": 1, "all_gather[model]": 2}
    assert wire["all_reduce[data,model]"] == ha._wire("all_reduce", 64, 640)
    assert wire["all_gather[model]"] == ha._wire("all_gather", 4, 400)
    assert link == {"ib": wire["all_reduce[data,model]"],
                    "nvlink": wire["all_gather[model]"]}


@pytest.fixture(scope="module")
def gloo_census():
    with tempfile.TemporaryDirectory() as d:
        job = Job("census", d, _RANKS, ranks=4)
        try:
            yield json.loads(str(job.result()["census"]))
        finally:
            job.kill()


def test_planned_census_equals_gloo_ranks(gloo_census):
    """The reduced qwen2 train step planned on a fake (2, 2) world: its
    census (calls and bytes by op and mesh dim, forward, backward and the
    optimizer's norm) equals rank 0's census of the same step in four gloo
    ranks, exactly."""
    from repro_torch.configs import registry
    from repro_torch.launch.cells import build_lm_cell
    from repro_torch.launch.mesh import make_plan_mesh, release_plan_world

    warnings.simplefilter("ignore")
    try:
        mesh = make_plan_mesh((2, 2), ("data", "model"))
        prog = build_lm_cell("qwen2-1.5b", "train_4k", mesh,
                             registry.get("qwen2-1.5b").make_reduced(),
                             LM_CELL)
        plan = prog.lower()
    finally:
        release_plan_world()
    assert plan.census["models"] == gloo_census
    assert sum(v["calls"] for v in gloo_census.values()) > 0
