"""Host-side graph containers, generators and the k-way partitioner (numpy)."""
