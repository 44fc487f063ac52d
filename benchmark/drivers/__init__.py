"""Traffic drivers, one module per traffic ``driver`` named in a traffic
file: each builds a cell's inputs, warms it, runs the measured window and
checks what the window produced."""
