"""Frozen copy of the port's self-contained chemistry (molecule graphs,
action enumeration, Morgan fingerprints, the SMILES codec, the conformer
model and the BDE/IP oracle), numpy only.  The benchmark's reference
enumerates, fingerprints and scores molecules with it, so that it shares no
module with the program it judges."""
