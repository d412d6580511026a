// Scene-file throughput harness: renders ANY reference-schema JSON scene
// through the REFERENCE renderer (linked via its public RAYLIB_API surface)
// and reports Mray/s from its own counters — used to measure the reference
// mesh baseline on the shared bench scene emitted by tools/bench_mesh.py,
// so bench.py's vs_baseline divides by a MEASURED number (an earlier 3.3
// Mray/s mesh constant was a fabricated fallback).
//
// Usage: bench_scene <scene.json> [size=512] [passes=8]
//        [renderer="Path Tracer MIS"] [maxDepth=6] [out.exr]

#include <limits>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <memory>

#include "Scene/Scene.h"
#include "Scene/Camera.h"
#include "Rendering/Renderer.h"
#include "Rendering/Viewport.h"
#include "Rendering/Context.h"
#include "Utils/Bitmap.h"
#include "Demo.h"  // headless stub (build_ref.sh patch 6)
#include "SceneLoader.h"

Options gOptions;  // referenced by SceneLoader/MeshLoader for dataPath

using namespace rt;

int main(int argc, char** argv)
{
    if (argc < 2)
    {
        fprintf(stderr, "usage: bench_scene <scene.json> [size] [passes] "
                        "[renderer] [maxDepth] [out.exr]\n");
        return 2;
    }
    const std::string scenePath = argv[1];
    const unsigned size = argc > 2 ? (unsigned)atoi(argv[2]) : 512;
    const unsigned passes = argc > 3 ? (unsigned)atoi(argv[3]) : 8;
    const char* rendererName = argc > 4 ? argv[4] : "Path Tracer MIS";
    const unsigned maxDepth = argc > 5 ? (unsigned)atoi(argv[5]) : 6;
    const char* outExr = argc > 6 ? argv[6] : nullptr;
    gOptions.dataPath = "";  // mesh paths in the bench scene are absolute

    Scene scene;
    Camera camera;
    if (!helpers::LoadScene(scenePath, scene, camera))
    {
        fprintf(stderr, "LoadScene failed: %s\n", scenePath.c_str());
        return 1;
    }
    if (!scene.BuildBVH())
    {
        fprintf(stderr, "BuildBVH failed\n");
        return 1;
    }

    Viewport viewport;
    viewport.Resize(size, size);

    RenderingParams params;
    params.maxRayDepth = maxDepth;
    params.numThreads = 0;  // all cores
    params.samplingParams.useBlueNoiseDithering = false;
    params.adaptiveSettings.enable = false;
    viewport.SetRenderingParams(params);

    RendererPtr renderer = CreateRenderer(rendererName, scene);
    if (!renderer)
    {
        fprintf(stderr, "unknown renderer: %s\n", rendererName);
        return 1;
    }
    viewport.SetRenderer(renderer);
    viewport.Reset();

    viewport.Render(camera);  // warmup (thread pool, caches)
    viewport.Reset();

    unsigned long long totalRays = 0;
    const auto t0 = std::chrono::steady_clock::now();
    for (unsigned i = 0; i < passes; ++i)
    {
        viewport.Render(camera);
        const RayTracingCounters& c = viewport.GetCounters();
        totalRays += c.numRays + c.numShadowRays;
    }
    const auto t1 = std::chrono::steady_clock::now();
    const double dt = std::chrono::duration<double>(t1 - t0).count();

    if (outExr)
    {
        viewport.GetSumBuffer().SaveEXR(outExr, 1.0f / (float)passes);
    }

    printf("{\"scene\": \"%s\", \"renderer\": \"%s\", \"size\": %u, \"passes\": %u, "
           "\"total_rays\": %llu, \"seconds\": %.4f, \"mrays_per_sec\": %.3f}\n",
           scenePath.c_str(), rendererName, size, passes, totalRays, dt,
           totalRays / dt / 1.0e6);
    return 0;
}
