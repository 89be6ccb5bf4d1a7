"""The benchmark's plain reference, written from the stages' definitions
and importing nothing of the program: the TRIP and AKAZE-MLDB frontends
(`trip`, `akaze`), the Hamming 2-NN (`match`), P3P, AC-RANSAC and the pose refinement
(`geometry`), the pose filter (`kalman`); `judge` holds the numbers that
decide `correct`, and `pipeline` the whole localization that the control
puts in the program's place."""
