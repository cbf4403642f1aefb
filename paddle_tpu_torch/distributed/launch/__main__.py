"""CLI: ``python -m paddle_tpu_torch.distributed.launch train.py [args]``.

The reference's options (``paddle_tpu/distributed/launch/__main__.py``),
over ``launch_utils.launch``. ``--devices`` / ``--gpus`` and
``--nproc_per_node`` are accepted and unused: one worker runs a node.
``--fleet_dir``, the ``--chaos_*`` fault injections and an elastic
``--nnodes min:max`` wait for ROADMAP queue A item 4 (f) and raise.
"""
import argparse
import sys

from ..launch_utils import _part_f, launch


def main(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--nnodes", type=str, default="1",
                   help="node count (an elastic 'min:max' range is not "
                        "supported yet)")
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--master", type=str, default=None,
                   help="host:port of the launcher store; the trainers' "
                        "store is on port + 2")
    p.add_argument("--log_dir", type=str, default="log")
    p.add_argument("--max_restarts", type=int, default=0)
    p.add_argument("--job_id", type=str, default="default")
    p.add_argument("--flight_dir", type=str, default=None,
                   help="arm the flight recorder in every worker: "
                        "post-mortem JSON dumps land in this directory")
    p.add_argument("--fleet_dir", type=str, default=None)
    p.add_argument("--metrics_dump", type=str, default=None,
                   help="base PADDLE_TPU_METRICS_DUMP path; each worker "
                        "writes <base>.rank<N>.json (an inherited env "
                        "path is rewritten the same way)")
    for name, kind in (("chaos_kill_rank", int), ("chaos_kill_step", int),
                       ("chaos_slow_rank", int),
                       ("chaos_slow_seconds", float),
                       ("chaos_creep_rank", int),
                       ("chaos_creep_pct", float)):
        p.add_argument(f"--{name}", type=kind, default=None)
    p.add_argument("--devices", "--gpus", type=str, default=None,
                   help="accepted; one worker runs a node")
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="accepted; one worker runs a node")
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    a = p.parse_args(argv)

    if a.fleet_dir:
        _part_f("--fleet_dir (fleet telemetry)")
    chaos = [k for k in vars(a) if k.startswith("chaos_")
             and getattr(a, k) is not None]
    if chaos:
        _part_f(f"--{chaos[0]} (fault injection into elastic training)")
    if ":" in a.nnodes:
        _part_f("an elastic --nnodes min:max")
    return launch(a.training_script, a.training_script_args, int(a.nnodes),
                  a.node_rank, a.master, a.log_dir, a.max_restarts,
                  a.job_id, a.flight_dir, None, a.metrics_dump)


if __name__ == "__main__":
    sys.exit(main())
