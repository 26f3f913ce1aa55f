"""The window's loops, one module a loop: a traffic mix names its loop
(`"loop": "<name>"`) and the harness imports `bench_port.loops.<name>` and
takes its `Loop` class. A new loop, or a new kind of scene node, arrives
as a new module here; `base.Loop` holds what the existing loops share."""
