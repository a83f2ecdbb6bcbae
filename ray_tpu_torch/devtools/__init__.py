"""Developer tooling for the ray_tpu_torch codebase (not part of the runtime).

Nothing under this package is imported by ``ray_tpu_torch`` at runtime;
the modules here are pure-stdlib so CI can run them without pulling in
torch or the native store.
"""
