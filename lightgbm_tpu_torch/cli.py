"""Config-file command-line front end: ``python -m lightgbm_tpu_torch``.

Port of ``lightgbm_tpu/cli.py`` (the reference CLI, ``src/main.cpp`` +
``src/application/application.cpp:209-281``): ``python -m
lightgbm_tpu_torch config=train.conf [key=value ...]`` dispatches on
``task`` — train, predict, refit, save_binary, convert_model and serve —
so the reference's example configs run unmodified; ``python -m
lightgbm_tpu_torch ingest data=<file> out=<dir>`` writes ``.lgbtpu``
shards (``data/ingest.py``; JAX ``cli.py:280-300``); ``python -m
lightgbm_tpu_torch monitor <run_dir|events.jsonl> [--check|--perf]``
renders a run-event log (``telemetry/monitor.py``; JAX
``cli.py:308-311``); ``python -m lightgbm_tpu_torch trace-doctor
[--device cpu]`` runs the trace doctor over the hot path
(``analysis/doctor.py``; JAX ``cli.py:301-305``); ``python -m
lightgbm_tpu_torch chaos [--fast] [--device cpu]`` runs the
fault-injection harness of the repo checkout,
``scripts/torch_chaos_train.py`` (JAX ``cli.py:312-327``). A train task
stopped by SIGTERM/SIGINT under ``resume`` writes its checkpoint and
exits 0 (JAX ``cli.py:190-199``).

Parameter precedence matches Application::LoadParameters
(application.cpp:31-86): command-line pairs beat config-file pairs;
within each source the first occurrence wins. Every task runs on
``device_type`` (default ``cuda``, which raises without a GPU);
``device_type=cpu`` runs the plain PyTorch versions on the host.

The JAX package's ``perf-gate`` waits for the port's benchmark: it
gates timings against a baseline measured on the card, and the port has
none yet, so the subcommand exits with that message. The port builds its kernels once into the ignored build directory, so
it has no counterpart of the JAX package's XLA compilation cache.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import numpy as np

from .config import Config
from .io import parse_config_file

__all__ = ["main", "run", "serve"]

# the CLI's own IO keys, which the training engine does not consume
# (output_model and snapshot_freq stay: train writes periodic snapshots)
_ENGINE_DROP = {
    "task", "data", "valid", "input_model", "output_result",
    "machine_list_filename", "local_listen_port", "save_binary",
    "two_round", "is_enable_sparse", "enable_bundle", "convert_model",
    "convert_model_language",
}

_USAGE = ("usage: python -m lightgbm_tpu_torch config=<file> "
          "[key=value ...]\n"
          "       python -m lightgbm_tpu_torch serve model=<file> "
          "[port=8080 ...]\n"
          "       python -m lightgbm_tpu_torch ingest data=<file> "
          "out=<dir> [key=value ...]\n"
          "       python -m lightgbm_tpu_torch monitor <run_dir|"
          "events.jsonl> [--check | --perf]\n"
          "       python -m lightgbm_tpu_torch trace-doctor "
          "[--device cpu] [--config C] [--mode M]\n"
          "       python -m lightgbm_tpu_torch chaos [--fast] "
          "[--elastic | --ingest] [--device cpu]\n"
          "tasks: train | predict | refit | save_binary | convert_model | "
          "serve | ingest | monitor | trace-doctor | chaos\n"
          "perf-gate waits for the port's benchmark (a baseline measured "
          "on the card)")


def _parse_argv(argv: List[str]) -> Dict[str, str]:
    """key=value pairs of the command line, then the config file's
    (cli.py:37); ``_conf_dir`` keeps the file's directory, against which
    relative paths resolve."""
    params: Dict[str, str] = {}
    for tok in argv:
        if "=" not in tok:
            raise SystemExit(f"unrecognized argument (want key=value): "
                             f"{tok!r}")
        k, v = tok.split("=", 1)
        params.setdefault(k.strip(), v.strip())
    conf = params.pop("config", params.pop("config_file", None))
    if conf:
        for k, v in parse_config_file(conf).items():
            params.setdefault(k, v)
        params["_conf_dir"] = os.path.dirname(os.path.abspath(conf))
    return params


def _resolve_path(path: str, conf_dir: Optional[str]) -> str:
    if os.path.isabs(path) or os.path.exists(path) or not conf_dir:
        return path
    cand = os.path.join(conf_dir, path)
    return cand if os.path.exists(cand) else path


def serve(params: Dict[str, str],
          conf_dir: Optional[str] = None) -> int:
    """task=serve: the prediction server (serving/server.py) over one or
    more registered models (cli.py:61). Serve-specific keys (port,
    max_batch_rows, ...) are not training parameters, so this path
    builds no Config."""
    from .serving import ModelRegistry, PredictionServer

    spec = params.get("model") or params.get("input_model")
    if not spec:
        raise SystemExit("task=serve needs model=<model file> "
                         "(or model=name:file[,name:file...])")
    device_type = params.get("device_type", "cuda")
    registry = ModelRegistry(
        warmup_rows=int(params.get("warmup_rows", 256)),
        device_type=device_type)
    truthy = ("1", "true", "yes", "on")
    server = PredictionServer(
        registry,
        host=params.get("host", "127.0.0.1"),
        port=int(params.get("port", 8080)),
        max_batch_rows=int(params.get("max_batch_rows", 1024)),
        max_wait_us=int(params.get("max_wait_us", 2000)),
        max_queue_rows=(int(params["max_queue_rows"])
                        if "max_queue_rows" in params else None),
        min_bucket=int(params.get("min_bucket", 16)),
        replicas=int(params.get("replicas", 0)),
        compiled_predict=(str(params.get("compiled_predict", ""))
                          .lower() in truthy),
        qps_budget=(float(params["qps_budget"])
                    if "qps_budget" in params else None),
        device_type=device_type)
    for item in str(spec).split(","):
        item = item.strip()
        if not item:
            continue
        name, sep, path = item.partition(":")
        if not sep:
            name, path = params.get("name", "default"), item
        mv = registry.register(name, _resolve_path(path, conf_dir))
        print(f"registered {mv.name} v{mv.version} "
              f"({mv.booster.num_trees()} trees) from {mv.source}",
              flush=True)
    server._bind()
    print(f"serving on http://{server.host}:{server.port} — endpoints: "
          "/predict /models /models/swap /models/rollback /healthz "
          "/healthz/alive /healthz/ready /metrics", flush=True)
    _install_drain_handler(server)
    server.serve_forever()
    # the drain runs on a helper thread (see _install_drain_handler);
    # wait for it so in-flight batcher work finishes before exit
    t = getattr(server, "_drain_thread", None)
    if t is not None:
        t.join(timeout=60)
        print("drained: in-flight work finished, exiting")
    return 0


def _install_drain_handler(server) -> None:
    """SIGTERM -> graceful drain (cli.py:115). The handler runs on the
    thread blocked in ``serve_forever``, so the drain runs on a helper
    thread; ``serve_forever`` then returns and the process exits 0."""
    import signal
    import threading

    def _on_term(signum, frame):
        print("SIGTERM: draining (not-ready; finishing in-flight "
              "work)", flush=True)
        t = threading.Thread(target=server.drain, name="serve-drain",
                             daemon=True)
        server._drain_thread = t
        t.start()

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        pass  # not on the main thread (embedded use)


def _write_result(path: str, out: np.ndarray) -> None:
    """One prediction a line, a row's columns tab-separated, each in
    ``%.18g`` (cli.py:222-228)."""
    fmt = "%.18g"
    if out.ndim == 1:
        np.savetxt(path, out, fmt=fmt)
    else:
        np.savetxt(path, out.reshape(out.shape[0], -1), fmt=fmt,
                   delimiter="\t")


def run(params: Dict[str, str]) -> int:
    """Run one task (cli.py:138)."""
    from .dataset import Dataset
    from .engine import Booster, train

    conf_dir = params.pop("_conf_dir", None)
    task = (params.get("task") or "train").strip()
    if task == "serve":
        return serve(params, conf_dir)
    cfg = Config({k: v for k, v in params.items() if k != "valid"})
    engine_params = {k: v for k, v in params.items()
                     if Config.canonical_name(k) not in _ENGINE_DROP}
    # a model loaded to predict or refit a data file reads it as the
    # training file was read
    model_params = {k: cfg.get(k) for k in (
        "device_type", "header", "label_column", "weight_column",
        "group_column", "ignore_column")}

    if task in ("train", "refit"):
        data_path = _resolve_path(cfg.data, conf_dir)
        if not data_path:
            raise SystemExit(f"task={task} needs data=<file>")
        train_set = Dataset(data_path, params=engine_params)
        if task == "refit":
            base = Booster(model_file=_resolve_path(cfg.input_model,
                                                    conf_dir),
                           params=model_params)
            train_set.construct()
            booster = base.refit(data_path, train_set.label)
            booster.save_model(cfg.output_model)
            print(f"Finished refit; model written to {cfg.output_model}")
            return 0
        valid_sets, valid_names = [], []
        # any alias of `valid` names the validation files
        vspec = next((v for k, v in params.items()
                      if Config.canonical_name(k) == "valid" and v), "")
        for i, v in enumerate(str(vspec).split(",")):
            v = v.strip()
            if not v:
                continue
            valid_sets.append(Dataset(_resolve_path(v, conf_dir),
                                      reference=train_set,
                                      params=engine_params))
            valid_names.append(f"valid_{i + 1}")
        if bool(cfg.save_binary):
            train_set.construct().save_binary(data_path + ".bin")
        callbacks = []
        if int(cfg.metric_freq) > 0 and int(cfg.verbosity) >= 0:
            from .callback import log_evaluation
            callbacks.append(log_evaluation(int(cfg.metric_freq)))
        from .resilience import TrainingPreempted
        try:
            booster = train(engine_params, train_set,
                            num_boost_round=int(cfg.num_iterations),
                            valid_sets=valid_sets, valid_names=valid_names,
                            callbacks=callbacks)
        except TrainingPreempted as e:
            # graceful preemption: the final checkpoint is on disk; exit
            # 0 so that a supervisor counts the eviction as clean
            print(f"Training preempted: {e}")
            print("Re-run with resume=auto to continue bit-identically.")
            return 0
        booster.save_model(cfg.output_model)
        print(f"Finished training; model written to {cfg.output_model}")
        return 0

    if task == "predict":
        booster = Booster(model_file=_resolve_path(cfg.input_model,
                                                   conf_dir),
                          params=model_params)
        n_iter = int(cfg.num_iteration_predict)
        pred = booster.predict(
            _resolve_path(cfg.data, conf_dir),
            raw_score=bool(cfg.predict_raw_score),
            pred_leaf=bool(cfg.predict_leaf_index),
            pred_contrib=bool(cfg.predict_contrib),
            start_iteration=int(cfg.start_iteration_predict),
            num_iteration=None if n_iter <= 0 else n_iter,
            pred_early_stop=bool(cfg.pred_early_stop),
            pred_early_stop_freq=int(cfg.pred_early_stop_freq),
            pred_early_stop_margin=float(cfg.pred_early_stop_margin))
        _write_result(cfg.output_result, np.asarray(pred))
        print(f"Finished prediction; results written to "
              f"{cfg.output_result}")
        return 0

    if task == "save_binary":
        data_path = _resolve_path(cfg.data, conf_dir)
        ds = Dataset(data_path, params=dict(engine_params,
                                            _allow_no_label=True))
        ds.construct().save_binary(data_path + ".bin")
        print(f"Binary dataset written to {data_path}.bin")
        return 0

    if task == "convert_model":
        from .codegen import model_to_c
        booster = Booster(model_file=_resolve_path(cfg.input_model,
                                                   conf_dir),
                          params=model_params)
        code = model_to_c(booster._all_trees(),
                          num_class=max(1, booster._num_class),
                          objective=booster._objective_name,
                          average_output=booster._average_output)
        with open(cfg.convert_model, "w") as f:
            f.write(code)
        print(f"Converted model written to {cfg.convert_model}")
        return 0

    raise SystemExit(f"unknown task: {task!r}")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_USAGE)
        return 0
    # `serve model=...`: the subcommand spelling of task=serve
    if argv[0] == "serve":
        argv = ["task=serve"] + argv[1:]
    if argv[0] == "ingest":
        # out-of-core shard construction: stream a CSV/npy/npz through
        # the mergeable quantile sketch and write checksummed .lgbtpu
        # shards that a Dataset trains from
        params = _parse_argv(argv[1:])
        conf_dir = params.pop("_conf_dir", None)
        data = params.pop("data", None)
        out = params.pop("out", params.pop("out_dir", None))
        if not data or not out:
            raise SystemExit("ingest needs data=<file> out=<dir>")
        label = params.pop("label_file", None)
        from .data.ingest import ingest as run_ingest
        summary = run_ingest(
            _resolve_path(data, conf_dir), _resolve_path(out, conf_dir),
            params=params,
            label=_resolve_path(label, conf_dir) if label else None)
        print(f"Ingest complete: {summary['total_rows']} rows -> "
              f"{summary['num_shards']} shards in {summary['out_dir']} "
              f"({summary['shards_written']} written, "
              f"{summary['shards_reused']} reused)")
        return 0
    # `monitor` — render a run-event log (telemetry/events.py) into a
    # phase/throughput/faults report; `--check` is the schema
    # self-check, `--perf` the profiler captures' summaries
    if argv[0] == "monitor":
        from .telemetry.monitor import monitor_main
        return monitor_main(argv[1:])
    # `trace-doctor` — the static-analysis battery (analysis/doctor.py);
    # argparse-style flags, not key=value, so it dispatches before run()
    if argv[0] in ("trace-doctor", "trace_doctor"):
        from .analysis.doctor import doctor_main
        return doctor_main(argv[1:])
    # `chaos` — the repo checkout's fault-injection harness,
    # scripts/torch_chaos_train.py (kill, corrupt, poison, splice,
    # ingest and elastic flows against an uninterrupted baseline)
    if argv[0] == "chaos":
        import importlib.util
        here = os.path.dirname(os.path.abspath(__file__))
        path = os.path.join(os.path.dirname(here), "scripts",
                            "torch_chaos_train.py")
        if not os.path.exists(path):
            raise SystemExit(
                "chaos harness not found (scripts/torch_chaos_train.py "
                "ships with the repo checkout, not the installed package)")
        spec = importlib.util.spec_from_file_location(
            "torch_chaos_train", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.main(argv[1:])
    if argv[0] in ("perf-gate", "perf_gate"):
        raise SystemExit(
            "perf-gate waits for the port's benchmark: it gates timings "
            "against a baseline measured on the card, and the port has "
            "none yet")
    return run(_parse_argv(argv))
