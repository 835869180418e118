"""Training: the train step (``train.step``) and the fault-tolerant loop
(``train.trainer``)."""
