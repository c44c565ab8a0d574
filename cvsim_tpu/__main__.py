import sys

# `-via` dispatches before cvsim_tpu.cli.main is imported: the thin client
# needs only stdlib (cli/serve.py run_via), so it starts in milliseconds and
# never initializes JAX or touches the device. Everything else goes through
# the full CLI.
if len(sys.argv) >= 3 and sys.argv[1] == "-via":
    from cvsim_tpu.cli.serve import run_via

    raise SystemExit(run_via(sys.argv[2], sys.argv[3:]))

from cvsim_tpu.cli.main import main

raise SystemExit(main())
