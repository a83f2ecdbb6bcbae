"""Traffic drivers, one a module, found by the name a workload file gives
in its ``traffic`` key. Each makes its inputs from the seed at set-up,
runs the window, counts the work attempted and failed, and hands its
outputs to the comparison (``setup``, ``window``, ``release``,
``numbers``, ``close``)."""
