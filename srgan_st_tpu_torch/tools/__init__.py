"""Command-line tools of the port that drive its training and losses from
outside: the kill/resume soak (`soak`), the loss-sensitivity study
(`loss_study`) and the per-op profile of one chunk of a row of the JAX
package's bench.py (`profile_step`)."""
