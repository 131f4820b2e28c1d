"""Host data model of the port: sequences, alignments, trees, file formats."""
