"""The benchmark's plain reference: what a frame of a cell should hold,
worked out in float64 from the seeded images and the job's parameters
alone. It imports nothing of the measured program."""
