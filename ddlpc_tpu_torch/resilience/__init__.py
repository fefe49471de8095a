"""The exit-status and breadcrumb protocol of a training process."""
