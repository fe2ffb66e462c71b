"""Seconds from the process's start to the window's opening: imports, the
kernel library, the hardware canary, the option and scene load, build and
one untimed frame of the cell's own shapes."""


def read(ctx):
    return ctx["setup_s"]
