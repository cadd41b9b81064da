"""Suite-wide settings that ``tests/conftest.py`` does not carry: each
xdist worker's share of the cores, and the per-test time limit of
``tests/time_limit.py``.

Every test under ``tests/`` runs under a limit: 120 s for setup, call
and teardown together, or what ``@pytest.mark.time_limit(seconds)`` or
the table below declares, above any timeout the test gives a child.
"""

import os
import pathlib

# Each xdist worker takes its share of the cores for the OpenMP and MKL
# pools of torch and numpy, which read this when they load; the
# processes the tests start inherit it.  Six workers of eight threads
# each on eight cores spent more time contending than computing: at
# one thread a worker, twelve of the port's heaviest test files took
# 917 test-seconds in place of 1,684 (8-core host, -n 6).
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    os.environ.setdefault("OMP_NUM_THREADS", str(max(1, len(
        os.sched_getaffinity(0)) // int(
            os.environ["PYTEST_XDIST_WORKER_COUNT"]))))

import pytest  # noqa: E402

pytest_plugins = ("tests.time_limit",)

TESTS = pathlib.Path(__file__).resolve().parent / "tests"
LIMIT_S = 120

# Limits of the reference's tests, each above the timeouts the test
# gives its children, keyed by file and test function.
REFERENCE_LIMITS = {
    # child timeout=120
    "test_contract_lint.py::test_graph_lint_cli_rejects_contracts_combos":
        180,
    "test_contract_lint.py::test_graph_lint_cli_contracts_runs_clean": 180,
    "test_obs.py::test_obs_report_cli": 180,
    "test_obs_live.py::"
    "test_live_plane_end_to_end_engine_healthz_slo_waterfall": 180,
    "test_shard_lint.py::test_graph_lint_cli_rejects_shardings_combos":
        180,
    # 3 attempts of 60 s and their barriers; 2 attempts of 100 s
    "test_cluster.py::test_driver_coordinated_restart_protocol": 300,
    "test_cluster.py::test_two_process_kill_one_host_coordinated_restart":
        300,
    # child timeout=300
    "test_budget_guards.py::test_graph_lint_cli_source_only_runs_clean":
        360,
    "test_graph_lint.py::test_graph_lint_cli_update_baseline": 360,
    "test_deploy.py::test_two_process_adag_matches_single_process": 360,
    "test_deploy.py::test_two_process_downpour_matches_single_process":
        360,
    "test_deploy.py::test_two_process_lm_trainer_matches_single_process":
        360,
    "test_deploy.py::test_two_process_model_axis_crosses_boundary": 360,
    "test_deploy.py::test_four_process_smoke": 360,
    "test_deploy.py::test_two_process_packed_training_matches_single": 360,
    "test_deploy.py::test_two_process_eval_dataset_matches_single": 360,
    "test_deploy.py::test_two_process_device_data_adag_matches_single":
        360,
    # two children of timeout=300
    "test_deploy.py::test_two_process_checkpoint_save_and_resume": 660,
    # child timeout=540
    "test_budget_guards.py::test_compile_count_guard_passes": 600,
    # child timeout=900
    "test_cluster.py::test_chaos_suite_cluster_ladder": 960,
    "test_zoo_and_entry.py::test_graft_entry_multichip": 960,
}


def pytest_collection_modifyitems(items):
    for item in items:
        if not item.path.is_relative_to(TESTS) \
                or item.get_closest_marker("time_limit") is not None:
            continue
        key = f"{item.path.name}::{getattr(item, 'originalname', item.name)}"
        item.add_marker(pytest.mark.time_limit(
            REFERENCE_LIMITS.get(key, LIMIT_S)))
