"""The plain reference that decides a run's `correct`.

Plain PyTorch and NumPy only: nothing here imports the measured package,
JAX or the JAX package.  It rebuilds the game, the networks and the PPO
update from the rules and the harness's own inputs (the seed, the seeded
weights, the configuration), and judges what the timed path produced
against them.
"""
