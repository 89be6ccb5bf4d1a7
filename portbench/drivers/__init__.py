"""One module a kind of traffic: each has a `Cell` that sets up a cell
from its configuration and traffic mix, serves its timed requests, and
checks their outputs against the plain reference."""
