"""Pixel shaders written as a user of the port writes them, named by a
configuration's ``pixel_shader`` and installed by its driver."""
