"""The option and scene load's seconds, as the program records them
(setup_stats["load_s"])."""


def read(ctx):
    return ctx["setup_stats"].get("load_s")
