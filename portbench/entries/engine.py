"""Traffic entry ``engine``: ``FusionEngine(cfg, device,
pipeline_depth).process`` with the traffic's ``pipeline_depth``.

Each frame's depth images and lidar packets are staged through
``add_depthmap`` / ``add_point_sequence``, then ``process`` runs the
step; the outputs it returns (with ``pipeline_depth=1``, the previous
frame's) are published before the next frame is released.
"""

from pb import drive


class Entry:
    def __init__(self, system, cfg, traffic, device):
        from ros_gpu_depthmap_fusion_tpu_torch.pipeline.engine import (
            FusionEngine)
        self.system = system
        self.engine = FusionEngine(cfg, device,
                                   pipeline_depth=traffic["pipeline_depth"])
        drive.wrap_engine(self.engine, system.spans)

    def feed(self, f: int) -> None:
        sc, eng = self.system.scene, self.engine
        depth, poses = sc.depth(f), sc.poses(f)
        for i in range(sc.c):
            eng.add_depthmap(i, depth[i], sc.intr, poses[i], poses[i])
        for pts, sec, nsec in sc.lidar(f):
            eng.add_point_sequence(pts, sec, nsec, drive.EYE)
        out = eng.process(sc.stamp(f))
        if out is not None:
            self.system.publish(out)

    def close(self) -> None:
        """Run the frame in flight to its end (its result is not
        counted), then stop the worker."""
        if self.engine.pipeline_depth:
            self.engine.flush()
        self.engine.close()
