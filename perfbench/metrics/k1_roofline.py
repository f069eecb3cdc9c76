"""K1's share of its roofline (:mod:`perfbench.rooflines`)."""

from perfbench import rooflines

read = rooflines.reader(__name__)
