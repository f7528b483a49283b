"""The closed loop of ``drivers/closed_loop.py`` with the scene's pixel
shader replaced, before the first frame, by the user's shader that the
configuration names (``"pixel_shader"``: ``benchmark/shaders/<name>.py``,
its ``pixel``). The vertex shader stays the port's builtin of the
configuration's ``shader``. Only the ``render`` entry: ``prepare()`` and
``render_prepared`` take builtin pixel shaders alone.
"""

from __future__ import annotations

import importlib

from benchmark.drivers import closed_loop


class Driver(closed_loop.Driver):
    def __init__(self, ctx):
        if ctx.cell.traffic["entry"] != "render":
            raise ValueError("a user's pixel shader runs through Scene.render() alone")
        super().__init__(ctx)
        shader = importlib.import_module(f"benchmark.shaders.{ctx.cell.config['pixel_shader']}")
        self.scene.pixel_shader = shader.pixel
