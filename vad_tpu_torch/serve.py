"""Serve an anomaly model over HTTP with the PyTorch port.

The flags of the JAX package's ``serve.py``, plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch versions of the kernels).  The
REST protocol is in ``vad_tpu_torch/eval/http_server.py``; either
package's ``ScoringClient`` drives it.  ``--data-parallel`` splits the
stream slots (and the image batch) over every card, one model replica per
card; ``--spatial N`` also splits each frame's rows over N of them
(``parallel/spatial.py``).

    python -m vad_tpu_torch.serve --checkpoint results/video_S01_.../best_model.ckpt \\
        --port 8600 --slots 16 --chunk 16

SIGINT (Ctrl-C) stops the watcher and the notifiers, closes the server and
exits with code 0.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Serve an anomaly model over HTTP (PyTorch port)")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="Model checkpoint (video -> /v1/streams API, image -> /v1/images)")
    p.add_argument("--image-checkpoint", type=str, default=None,
                   help="Serve an image model ALONGSIDE the video --checkpoint "
                        "from the same daemon (/v1/streams and /v1/images both "
                        "live; /v1/reload routes by checkpoint kind)")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=8600)
    p.add_argument("--slots", type=int, default=16,
                   help="Parallel stream capacity (video) / batch capacity (image)")
    p.add_argument("--chunk", type=int, default=16, help="Frames per scoring request")
    p.add_argument("--slot-ttl", type=float, default=None, metavar="SECONDS",
                   help="Reclaim video stream slots idle longer than this "
                        "when capacity runs out (a crashed client cannot "
                        "leak its slot forever); default: slots are only "
                        "freed by explicit DELETE")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"],
                   help="Serving precision policy")
    p.add_argument("--fused-input", action="store_true",
                   help="Use the fused u8 input block (csrc/first_block.cu); "
                        "on the card it is on by default for a batch-norm, "
                        "pool-stem model")
    p.add_argument("--data-parallel", action="store_true",
                   help="Split stream slots + carried state over all visible "
                        "cards ('data'-axis mesh); each card's model replica "
                        "serves slots/n_cards independent streams")
    p.add_argument("--spatial", type=int, default=1, metavar="N",
                   help="Also split image rows over a 'model' mesh axis of "
                        "size N (spatial partitioning for few high-resolution "
                        "streams; requires H and H/16 divisible by N and N "
                        "devices; kernel 1 runs its row form)")
    p.add_argument("--watch", type=str, default=None, metavar="PATH",
                   help="Auto-deploy: poll this checkpoint file or results "
                        "directory (recursive best_model.ckpt scan) and "
                        "hot-reload the newest checkpoint with zero downtime "
                        "whenever it changes")
    p.add_argument("--watch-interval", type=float, default=30.0,
                   help="Seconds between --watch polls")
    p.add_argument("--alert-url", type=str, default=None, metavar="URL",
                   help="POST JSON alerts here: stream_anomaly when a video "
                        "stream stays above the calibrated threshold for "
                        "--alert-consecutive chunks (needs a calibrated "
                        "frame threshold), and score_drift when any served "
                        "model's drift monitor trips (see --drift-window)")
    p.add_argument("--alert-consecutive", type=int, default=3,
                   help="Consecutive anomalous chunks before alerting")
    p.add_argument("--alert-cooldown", type=float, default=60.0,
                   help="Seconds between repeat alerts for the same stream")
    p.add_argument("--drift-window", type=int, default=4096,
                   help="Scores kept in the online drift monitor's window "
                        "(per model kind; summarized at /v1/metrics with a "
                        "'drifting' verdict against the calibrated ~1%% "
                        "exceedance contract). 0 disables monitoring")
    p.add_argument("--drift-factor", type=float, default=5.0,
                   help="Declare drift when the observed exceedance rate is "
                        "this many times the calibrated contract")
    p.add_argument("--latent-stats", type=str, default=None, metavar="NPZ",
                   help="Serve /v1/images through the latent-distance "
                        "(Mahalanobis) scorer using these fitted statistics "
                        "(written by evaluate --scorer latent as "
                        "latent_stats.npz). The stats must be fitted on the "
                        "served image checkpoint's weights; /v1/reload then "
                        "requires a matching new latent_stats path in its "
                        "body, and --watch auto-reloads are refused (stale "
                        "statistics over new weights would score garbage)")
    p.add_argument("--reload-root", type=str, action="append", default=None,
                   metavar="DIR",
                   help="Additional directory POST /v1/reload may load "
                        "checkpoints from (repeatable). By default reload "
                        "is restricted to the served checkpoints' run dirs "
                        "plus the --watch path; paths outside every root "
                        "are refused with 403")
    p.add_argument("--device", type=str, default="cuda",
                   help="Torch device; 'cpu' runs the plain PyTorch versions "
                        "of the kernels")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.watch and args.fused_input:
        # kept as the JAX CLI has it, so both CLIs accept the same flags
        # (the port's scorer itself refolds the fused block on reload)
        parser.error("--watch cannot be combined with --fused-input "
                     "(fused servers do not support hot reload)")
    if args.watch and args.latent_stats:
        # the watcher cannot fit new statistics; auto-deploying weights
        # under a latent scorer would be refused on every poll
        parser.error("--watch cannot be combined with --latent-stats "
                     "(reload a latent server explicitly via /v1/reload "
                     "with a freshly fitted latent_stats path)")
    from vad_tpu_torch.eval.http_server import CheckpointWatcher, serve_from_checkpoint

    reload_roots = list(args.reload_root or [])
    if args.watch:
        reload_roots.append(args.watch)
    server = serve_from_checkpoint(
        args.checkpoint, args.host, args.port, args.slots, args.chunk,
        args.dtype, fused_input=args.fused_input or None,
        data_parallel=args.data_parallel, spatial_parallel=args.spatial,
        image_checkpoint=args.image_checkpoint, slot_ttl=args.slot_ttl,
        drift_window=args.drift_window, drift_factor=args.drift_factor,
        reload_roots=reload_roots, latent_stats=args.latent_stats,
        device=args.device,
    )
    h = server.service.health()
    if h["model_type"] == "video":
        desc = f"{h['num_slots']} slots x {h['chunk']}-frame chunks"
    else:
        desc = f"image batches up to {h['batch']}, {h['scorer']} scorer"
    if args.image_checkpoint:
        desc += f" + image model {args.image_checkpoint}"
    print(f"Serving {args.checkpoint} on {args.host}:{server.port} ({desc}, {h['dtype']})",
          flush=True)
    notifiers = []
    if args.alert_url:
        from vad_tpu_torch.eval.alerts import AlertNotifier

        # one notifier per service so /v1/metrics delivery counters stay
        # per model; video gets stream-streak + drift alerts, the
        # stateless image service drift alerts only
        for kind, svc in server.services.items():
            n = AlertNotifier(
                args.alert_url, consecutive=args.alert_consecutive,
                cooldown=args.alert_cooldown,
            )
            svc.notifier = n
            notifiers.append(n)
            if kind == "video" and svc.score_threshold is None:
                print("WARNING: video checkpoint has no calibrated frame "
                      "threshold; stream alerts will not fire until one "
                      "is hot-reloaded in")
        print(f"Alerting to {args.alert_url}: stream anomalies after "
              f"{args.alert_consecutive} consecutive anomalous chunks, "
              f"plus score_drift events from the drift monitor", flush=True)
    watcher = None
    if args.watch:
        # the server-level reload routes by checkpoint kind, so the
        # watcher deploys image AND video retrains on a dual server
        watcher = CheckpointWatcher(
            server, args.watch, interval=args.watch_interval,
            initial=args.checkpoint,
        )
        watcher.start()
        print(f"Watching {args.watch} for newer checkpoints "
              f"(every {args.watch_interval:.0f}s)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        if watcher is not None:
            watcher.stop()
        for n in notifiers:
            n.close()
        server.close()


if __name__ == "__main__":
    main()
