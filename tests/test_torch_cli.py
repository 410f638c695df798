"""The port's command line vs the JAX package's, on the CPU.

Every option of the reference's ``cli.build_argparser`` exists in the
port's with the same ``dest``, type, choices, default, ``nargs`` and
action, and parses the same argument to the same value; ``main`` turns
the same flags into the same config overrides (the ``--no_*`` switches
included); the router's ``_passthrough_flags`` renders overrides the
port's child CLI parses back to the same values; and the trainer, the
server and the router log as inert exactly the settings the port does
not run yet.
"""

import argparse
import logging

import pytest

from fast_tffm_tpu import cli as jax_cli
from fast_tffm_tpu_torch import cli
from fast_tffm_tpu_torch.config import FmConfig, load_config
from fast_tffm_tpu_torch.serve import router, server
from fast_tffm_tpu_torch.train import loop

# One argument per option kind, valid for each option's type and choices.
_SAMPLE = {int: "7", float: "0.25", None: "x"}


def _options(parser: argparse.ArgumentParser) -> dict:
    return {opt: a for a in parser._actions for opt in a.option_strings
            if opt not in ("-h", "--help")}


def _signature(action) -> tuple:
    return (action.dest, action.type, action.choices, action.default,
            action.nargs, action.const, type(action).__name__)


def _argv_for(opt: str, action) -> list:
    if action.nargs == 0:
        return [opt]
    if action.choices:
        return [opt, str([c for c in action.choices if c is not None][-1])]
    return [opt, _SAMPLE[action.type]]


REF_OPTIONS = _options(jax_cli.build_argparser())


@pytest.mark.parametrize("opt", sorted(REF_OPTIONS))
def test_every_reference_option_parses_alike(opt):
    ref = REF_OPTIONS[opt]
    ours = _options(cli.build_argparser()).get(opt)
    assert ours is not None, f"the port's CLI lacks {opt}"
    assert _signature(ours) == _signature(ref)
    argv = ["train", "x.cfg"] + _argv_for(opt, ref)
    got = getattr(cli.build_argparser().parse_args(argv), ref.dest)
    want = getattr(jax_cli.build_argparser().parse_args(argv), ref.dest)
    assert got == want


def test_the_twenty_five_missing_options_are_there():
    added = ("--steps_per_dispatch", "--cache_epochs", "--cache_max_bytes",
             "--cache_prestacked", "--parse_processes",
             "--prefetch_super_batches", "--ring_slots",
             "--serve_http_threads", "--serve_http_acceptors",
             "--serve_parse_mode", "--serve_transport", "--heartbeat_secs",
             "--nan_policy", "--status_port", "--status_host",
             "--train_fleet_scrape", "--quality_window", "--incident_dir",
             "--trace_rotate_events", "--interaction_impl",
             "--compile_cache_dir", "--no_telemetry", "--no_quality",
             "--no_blackbox", "--no_resource_metrics")
    assert len(set(added)) == 25
    ours = _options(cli.build_argparser())
    assert all(opt in ours and opt in REF_OPTIONS for opt in added)


def _capture_config(monkeypatch, module, argv) -> FmConfig:
    """The config ``module.main(argv)`` builds, stopped before it
    runs anything."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_load(path, overrides=None):
        seen["overrides"] = dict(overrides or {})
        raise Stop

    import fast_tffm_tpu.config as jax_config
    import fast_tffm_tpu_torch.config as port_config

    target = port_config if module is cli else jax_config
    monkeypatch.setattr(target, "load_config", fake_load)
    with pytest.raises(Stop):
        module.main(argv)
    return seen["overrides"]


def test_main_builds_the_references_overrides(monkeypatch):
    argv = ["train", "x.cfg", "--steps_per_dispatch", "4", "--cache_epochs",
            "--cache_max_bytes", "1024", "--cache_prestacked",
            "--parse_processes", "2", "--prefetch_super_batches", "3",
            "--ring_slots", "5", "--heartbeat_secs", "0.5",
            "--nan_policy", "halt", "--status_port", "9100",
            "--status_host", "0.0.0.0", "--alert_rules", "step > 0 : warn",
            "--train_fleet_scrape", "h:1", "--quality_window", "64",
            "--incident_dir", "/tmp/i", "--trace", "t.json",
            "--trace_rotate_events", "10", "--interaction_impl", "pallas",
            "--compile_cache_dir", "/tmp/c", "--serve_transport", "bin",
            "--serve_parse_mode", "legacy", "--serve_http_threads", "4",
            "--serve_http_acceptors", "2", "--metrics_file", "m.jsonl",
            "--no_telemetry", "--no_quality", "--no_blackbox",
            "--no_resource_metrics", "--no_serve_canary"]
    ours = _capture_config(monkeypatch, cli, argv)
    ref = _capture_config(monkeypatch, jax_cli, argv)
    assert ours == ref
    assert ours["telemetry"] is ours["blackbox"] is False
    assert ours["nan_policy"] == "halt" and ours["status_port"] == 9100


@pytest.mark.parametrize("overrides", [
    {"steps_per_dispatch": 4, "cache_epochs": True, "parse_processes": 2,
     "heartbeat_secs": 0.5, "nan_policy": "halt", "status_port": 9100,
     "status_host": "0.0.0.0", "telemetry": False,
     "resource_metrics": False, "quality": False, "blackbox": False},
    {"serve_transport": "bin", "serve_parse_mode": "legacy",
     "serve_http_threads": 4, "serve_http_acceptors": 2,
     "interaction_impl": "packed", "compile_cache_dir": "/tmp/c",
     "quality_window": 64, "serve_table_dtype": "int8",
     "serve_batch_sizes": "8,32"},
])
def test_passthrough_flags_parse_in_the_child_cli(overrides, tmp_path):
    flags = router._passthrough_flags(overrides)
    args = cli.build_argparser().parse_args(["serve", "x.cfg"] + flags)
    for key, val in overrides.items():
        if key in ("telemetry", "resource_metrics"):
            assert getattr(args, f"no_{key}") is (val is False)
        elif key in ("quality", "blackbox"):
            continue  # the reference passes no switch for these
        else:
            assert getattr(args, key) == val, key
    # And the child's config loads.
    cfg_path = tmp_path / "x.cfg"
    cfg_path.write_text("[General]\nvocabulary_size = 64\n")
    child = {k: getattr(args, k) for k in overrides
             if k not in ("telemetry", "resource_metrics", "quality",
                          "blackbox")}
    load_config(str(cfg_path), child)


def test_trainer_logs_only_the_planes_it_does_not_run(caplog, tmp_path):
    cfg = FmConfig(vocabulary_size=64, train_fleet_scrape="h:1",
                   heartbeat_secs=1, compile_cache_dir="/tmp/c",
                   nan_policy="halt", metrics_file=str(tmp_path / "m"),
                   status_port=9100, alert_rules="step > 0 : warn")
    with caplog.at_level(logging.INFO, logger="fast_tffm_tpu_torch"):
        loop.Trainer(cfg, device="cpu")
    line = [r.message for r in caplog.records
            if "does not run these planes" in r.message]
    assert len(line) == 1
    for plane in ("training-fleet scrape", "compile cache", "quality plane",
                  "blackbox"):
        assert plane in line[0]
    for live in ("health", "metrics stream", "heartbeat", "status endpoint",
                 "alerts"):
        assert live not in line[0]
    assert {k for k, _ in loop._INERT_PLANES} == {
        "quality", "trace_file", "blackbox", "profile_dir",
        "train_fleet_scrape", "compile_cache_dir"}
    for knobs in (server._INERT_KNOBS, router._INERT_KNOBS):
        assert not {"metrics_file", "heartbeat_secs",
                    "alert_rules"} & set(knobs)
