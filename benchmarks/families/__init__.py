"""One module a model family: how a configuration file maps onto the
program's config and the reference, the weights' layout, and the
family's FLOP counts. The harness finds it by the configuration's
``family``."""
