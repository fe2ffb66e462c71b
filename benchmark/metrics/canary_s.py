"""The hardware canary's seconds, as the program records them
(setup_stats["canary_s"])."""


def read(ctx):
    return ctx["setup_stats"].get("canary_s")
