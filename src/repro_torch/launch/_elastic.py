"""The elastic flags and signals that ``launch.train`` and
``launch.serve`` share: the reference launchers' ``--elastic``,
``--fault-*``, ``--max-recoveries``, ``--watchdog-timeout`` and
``--ctrl-*`` flags, and what an elastic run listens to (SIGTERM as a
preemption notice, the control plane's vote)."""

from __future__ import annotations

import argparse
import logging

from repro_torch.runtime import ctrlplane, health

logger = logging.getLogger("repro_torch.launch")

# Only --elastic uses these flags, so they are refused without it.
_ELASTIC_FLAGS = ("fault_plan", "max_recoveries", "watchdog_timeout",
                  "ctrl_peers", "ctrl_port", "ctrl_member",
                  "ctrl_fault_plan")


def add_elastic_args(ap: argparse.ArgumentParser, what: str) -> None:
    """The reference launchers' elastic flags (``--elastic``,
    ``--fault-*``, ``--max-recoveries``, ``--watchdog-timeout`` and the
    control plane's ``--ctrl-*``)."""
    g = ap.add_argument_group("elastic " + what)
    g.add_argument("--elastic", action="store_true",
                   help="supervise the run with the elastic controller "
                        "(re-mesh over the survivors on a loss)")
    g.add_argument("--fault-plan", default="",
                   help="deterministic fault injection, e.g. "
                        "'lose@5:2,gain@9:2,stall@7'")
    g.add_argument("--fault-seed", type=int, default=0,
                   help="seed of the fault victims' choice")
    g.add_argument("--max-recoveries", type=int, default=None,
                   help="abort after this many recoveries (default 8)")
    g.add_argument("--watchdog-timeout", type=float, default=None,
                   help="seconds without a step before a stall "
                        "(default 300)")
    g.add_argument("--ctrl-peers", default="",
                   help="control-plane peers as 'host:port,host:port' "
                        "(the OTHER members); re-meshes then happen only "
                        "on committed, fenced epochs")
    g.add_argument("--ctrl-port", type=int, default=None,
                   help="TCP port this member listens on (0 = "
                        "ephemeral; peers must name the real port)")
    g.add_argument("--ctrl-host", default="127.0.0.1",
                   help="address this member is ADVERTISED as (its id "
                        "defaults to '<ctrl-host>:<port>')")
    g.add_argument("--ctrl-member", default="",
                   help="explicit member id, when the peers' lists use "
                        "'name=host:port' entries")
    g.add_argument("--heartbeat-interval", type=float, default=0.5,
                   help="control-plane heartbeat cadence in seconds")
    g.add_argument("--ctrl-fault-plan", default="",
                   help="injected control-plane message faults, e.g. "
                        "'drop@3:2,partition@0:40'")


def check_elastic_args(ap: argparse.ArgumentParser,
                       args: argparse.Namespace) -> None:
    """Refuse elastic flags without ``--elastic`` (they would be
    ignored) and fill in their defaults."""
    used = [f for f in _ELASTIC_FLAGS if getattr(args, f) not in (None, "")]
    if used and not args.elastic:
        ap.error(", ".join("--" + f.replace("_", "-") for f in used)
                 + " needs --elastic")
    if args.max_recoveries is None:
        args.max_recoveries = 8
    if args.watchdog_timeout is None:
        args.watchdog_timeout = 300.0
    if args.ctrl_port is None:
        args.ctrl_port = 0


def elastic_signals(args: argparse.Namespace, mesh):
    """(preemption notice, control-plane membership or None) of an
    elastic run: SIGTERM (what schedulers send ahead of an eviction)
    becomes a step-boundary drain of every member this process holds,
    and ``--ctrl-peers`` joins the TCP control plane."""
    notice = health.PreemptionNotice()
    try:
        health.install_preemption_handler(notice, mesh.members)
    except ValueError:                       # not the main thread
        logger.warning("not on the main thread: SIGTERM preemption "
                       "handler not installed")
    membership = None
    if args.ctrl_peers:
        membership = ctrlplane.connect(
            args.ctrl_member or None, port=args.ctrl_port,
            host=args.ctrl_host, peers=args.ctrl_peers,
            config=ctrlplane.CtrlConfig(
                heartbeat_interval=args.heartbeat_interval,
                heartbeat_timeout=5 * args.heartbeat_interval),
            fault_plan=(ctrlplane.CtrlFaultPlan.parse(
                args.ctrl_fault_plan, seed=args.fault_seed)
                if args.ctrl_fault_plan else None))
        logger.info("control plane: %s with peers %s", membership.member,
                    membership.peers)
    return notice, membership
