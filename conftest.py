"""Every test under tests/ runs under a time limit (tests/time_limit.py)."""

import pathlib
import sys

TESTS = pathlib.Path(__file__).resolve().parent / "tests"
sys.path.append(str(TESTS))
pytest_plugins = ("time_limit",)


def pytest_configure(config):
    plugin = config.pluginmanager.get_plugin("time_limit")
    if plugin is not None:  # not under -p no:time_limit
        plugin.ONLY_UNDER = TESTS
