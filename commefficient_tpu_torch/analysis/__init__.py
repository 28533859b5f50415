"""Analysis of the port's rounds: the roofline cost model
(``cost.py``)."""
