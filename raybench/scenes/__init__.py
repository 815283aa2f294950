"""Frozen scene recipes: each configuration's ``recipe`` names a module
here whose ``make(scene_params)`` returns the scene's inputs as numpy
arrays.  Both the program and the reference are given these inputs."""
