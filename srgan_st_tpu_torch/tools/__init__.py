"""Command-line tools of the port that drive its training and losses from
outside: the kill/resume soak (`soak`), the loss-sensitivity study
(`loss_study`), the bench (`bench`, front end bench_torch.py) and its
per-op profile of one chunk (`profile_step`)."""
