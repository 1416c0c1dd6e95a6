"""Controller process entrypoint (reference analog: `gcs_server_main.cc` +
`raylet/main.cc` combined — see controller.py for the redesign rationale)."""

import asyncio
import os

import cloudpickle

from .controller import run_controller


def main():
    from .rpc import ensure_auth_token

    if os.environ.get("RAY_TPU_CTRL_STACKDUMP"):
        # Dev tool: periodic all-thread stack dumps into the controller log
        # (what IS the event loop doing during a stall?).
        import faulthandler

        faulthandler.dump_traceback_later(3, repeat=True)

    # Manually-started heads (no driver set the secret yet): generate one —
    # spawned workers/agents inherit it; drivers discover it in address.json.
    ensure_auth_token()
    args = cloudpickle.loads(bytes.fromhex(os.environ["RAY_TPU_CONTROLLER_ARGS"]))
    # Surface the shard layout in the session log (stderr → controller.log):
    # postmortems need to know which partitioning a session actually ran
    # with (control_shards.py; the count is config, not snapshot, state).
    import sys

    from . import config as rt_config

    print(
        f"controller: shards={rt_config.get('controller_shards')} "
        f"shard_threads={rt_config.get('controller_shard_threads')}",
        file=sys.stderr, flush=True,
    )
    profile_path = os.environ.get("RAY_TPU_CONTROLLER_PROFILE")
    if profile_path:
        # Control-plane profiling (dev tool): cProfile the whole event loop,
        # dump pstats on exit. `pstats.Stats(path).sort_stats("cumulative")`.
        import cProfile

        prof = cProfile.Profile()
        prof.enable()
        try:
            asyncio.run(run_controller(args))
        finally:
            prof.disable()
            prof.dump_stats(profile_path)
    else:
        asyncio.run(run_controller(args))


if __name__ == "__main__":
    main()
