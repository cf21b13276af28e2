"""Command-line tools of the port that drive its training and losses from
outside: the kill/resume soak (`soak`) and the loss-sensitivity study
(`loss_study`)."""
