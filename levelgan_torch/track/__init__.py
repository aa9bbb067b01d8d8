"""Race-track model family: port of ``levelgan/track/``.

A GRU segment emitter generates tracks as (curvature, width) sequences, a
1-D conv critic scores them, and in the curriculum two MLP drivers race
them (``race.py``), the generator being rewarded for drivable tracks that
separate the strong driver from the weak one.  ``ModelConfig.family =
'track'``; presets ``racetrack_32`` and ``race_curriculum_32``.
"""
