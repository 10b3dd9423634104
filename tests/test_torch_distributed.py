"""Launch detection and the process group's set-up (parallel/distributed.py),
after tests/test_distributed.py: ``detect_pod_env`` on stubbed environment
mappings, and ``setup_distributed`` with ``init_process_group`` stubbed, so no
process is started. Also the data axis's answers before any group is up.
"""
import pytest
import torch

from msla_tpu_torch.parallel import distributed as dist
from msla_tpu_torch.parallel import mesh

LAUNCH_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
               "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
               "JAX_PROCESS_INDEX", "MSLA_PLATFORM")


@pytest.fixture
def clean_env(monkeypatch):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    yield monkeypatch
    mesh.forget_process_rank()


@pytest.mark.parametrize("env", [{}, {"WORLD_SIZE": "1"}, {"MASTER_ADDR": "h"},
                                 {"JAX_NUM_PROCESSES": "1"},
                                 {"TPU_WORKER_HOSTNAMES": "w0,w1"},
                                 {"MEGASCALE_COORDINATOR_ADDRESS": "coord:8080"}],
                         ids=["empty", "world1", "master_only", "jax1", "tpu_pod", "gke"])
def test_one_process_is_none(env):
    """The TPU pod and GKE markers are not read: there is no TPU."""
    assert dist.detect_pod_env(env) is None


def test_torch_env_contract():
    spec = dist.detect_pod_env({"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "4242",
                                "WORLD_SIZE": "8", "RANK": "5", "LOCAL_RANK": "1"})
    assert spec == {"coordinator_address": "10.0.0.1:4242", "num_processes": 8,
                    "process_id": 5, "local_rank": 1}
    # rank 0 parses as 0; torch's default port; a launch of one process still counts
    spec = dist.detect_pod_env({"MASTER_ADDR": "h", "WORLD_SIZE": "1", "RANK": "0"})
    assert spec == {"coordinator_address": "h:29500", "num_processes": 1, "process_id": 0,
                    "local_rank": None}


def test_jax_launcher_contract():
    spec = dist.detect_pod_env({"JAX_COORDINATOR_ADDRESS": "10.0.0.1:8476",
                                "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "2"})
    assert spec == {"coordinator_address": "10.0.0.1:8476", "num_processes": 4,
                    "process_id": 2, "local_rank": None}
    assert dist.detect_pod_env({"JAX_COORDINATOR_ADDRESS": "c:1",
                                "JAX_PROCESS_ID": "0"})["process_id"] == 0


def test_torch_env_wins_over_the_jax_launchers():
    spec = dist.detect_pod_env({"MASTER_ADDR": "a", "MASTER_PORT": "1", "WORLD_SIZE": "2",
                                "RANK": "1", "JAX_COORDINATOR_ADDRESS": "b:2",
                                "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "3"})
    assert (spec["coordinator_address"], spec["num_processes"], spec["process_id"]) == \
        ("a:1", 2, 1)


def test_one_process_sets_up_nothing(clean_env):
    assert dist.setup_distributed() is False
    assert mesh.process_info() == (0, 1) and mesh.is_main_process()


def _stub_init(monkeypatch):
    calls = {}
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend, **kw))
    return calls


def test_cpu_platform_takes_gloo(clean_env):
    calls = _stub_init(clean_env)
    for var, value in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", "1234"),
                       ("WORLD_SIZE", "2"), ("RANK", "1"), ("LOCAL_RANK", "1"),
                       ("MSLA_PLATFORM", "cpu")):
        clean_env.setenv(var, value)
    assert dist.setup_distributed() is True
    assert calls == {"backend": "gloo", "init_method": "tcp://localhost:1234",
                     "world_size": 2, "rank": 1}
    assert mesh.process_info() == (1, 2) and not mesh.is_main_process()


def test_the_card_takes_nccl_and_never_gloo(clean_env):
    """Without --platform cpu the group is NCCL's on cuda:LOCAL_RANK; with no
    card that raises rather than falling back to gloo."""
    calls = _stub_init(clean_env)
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dist.setup_distributed("localhost:1234", 2, 0)
    assert calls == {}


def test_a_launch_without_a_rank_raises(clean_env):
    clean_env.setenv("MASTER_ADDR", "localhost")
    clean_env.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="rank"):
        dist.setup_distributed()
    with pytest.raises(RuntimeError, match="no rank is known"):
        mesh.is_main_process()


@pytest.mark.parametrize("var,value,main", [("RANK", "0", True), ("RANK", "3", False),
                                            ("JAX_PROCESS_ID", "1", False)])
def test_the_rank_before_any_group_comes_from_the_launch(clean_env, var, value, main):
    clean_env.setenv(var, value)
    assert mesh.is_main_process() is main


@pytest.mark.parametrize("kw", [dict(devices=1), dict(devices=-1), dict(devices=-1, num_nodes=1)])
def test_one_process_resolves_to_its_device(clean_env, kw):
    assert mesh.resolve_devices("cpu", **kw) == torch.device("cpu")


@pytest.mark.parametrize("kw", [dict(devices=2), dict(num_nodes=2), dict(devices=1, num_nodes=2)])
def test_more_devices_than_ranks_name_the_launcher(clean_env, kw):
    with pytest.raises(ValueError, match="msla_tpu_torch.parallel.launch"):
        mesh.resolve_devices("cpu", **kw)


def test_collectives_are_no_ops_without_a_group():
    t = torch.arange(4.0)
    with mesh.data_axis():
        assert mesh.all_sum(t) is t and mesh.all_max(t) is t and mesh.all_sum_autograd(t) is t
        assert mesh.gather_rows(t) is t
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 2.0)
    mesh.mean_gradients([p])
    assert torch.equal(p.grad, torch.full((3,), 2.0))
    mesh.barrier()
