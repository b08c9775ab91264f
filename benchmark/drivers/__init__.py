"""One module per entry point of the program that a traffic mix can drive,
found by the traffic file's `entry`. Each has `run(cell) -> Outcome`."""
