"""Path-depth constant of the reference integrators (port of the
`MAX_DEPTH` of henjou_tpu/integrator/pathtrace.py).

The masked depth-loop path tracer itself is not ported yet: the port
renders with the wavefront engine (integrator/wavefront.py), and the
masked engine is ROADMAP Queue 1, masked engine.
"""

MAX_DEPTH = 10  # reference: rt.h:89
