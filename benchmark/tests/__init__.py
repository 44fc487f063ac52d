"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``. Those
marked ``cuda`` need the card and skip where torch sees none."""
